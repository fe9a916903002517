"""Procedural fixture scenes (BASELINE.json configs 1-3 plus a textured
quad), built through the real GLB round trip (writer -> parser) so
ingest is exercised everywhere they're used: tests, the CLI and
chip_smoke.py.

The reference's equivalents are assets/triangle.glb and assets/cube.glb
(its heavier scenes are gitignored and not distributed)."""

from __future__ import annotations

import numpy as np

from sycl_ray_tracer_torch.utils.glb_writer import GlbBuilder
from sycl_ray_tracer_torch.utils.png import encode_png


def _quad(center, size, axis):
    """Two triangles forming a square facing +axis."""
    c = np.asarray(center, np.float32)
    u = np.zeros(3, np.float32)
    v = np.zeros(3, np.float32)
    u[(axis + 1) % 3] = size
    v[(axis + 2) % 3] = size
    p = np.stack([c - u - v, c + u - v, c + u + v, c - u + v])
    n = np.zeros((4, 3), np.float32)
    n[:, axis] = 1.0
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    return p, n, uv, idx


def _icosphere(radius=1.0, subdiv=2):
    """Standard icosphere subdivision (vertices on the unit sphere)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ])
    for _ in range(subdiv):
        vlist = list(verts)
        cache = {}
        new_faces = []

        def mid(a, b):
            k = (min(a, b), max(a, b))
            if k not in cache:
                m = verts_arr[a] + verts_arr[b]
                m /= np.linalg.norm(m)
                cache[k] = len(vlist)
                vlist.append(m)
            return cache[k]

        verts_arr = verts
        for f in faces:
            a, b, c = f
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces)
    verts = verts * radius
    normals = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    uv = np.zeros((len(verts), 2), np.float32)
    return verts.astype(np.float32), normals.astype(np.float32), uv, \
        faces.astype(np.uint32).reshape(-1)


def triangle_scene_glb() -> bytes:
    """BASELINE config 1: one diffuse triangle + camera + sky."""
    b = GlbBuilder()
    mat = b.add_material(base_color=(0.9, 0.2, 0.2), metallic=0.0,
                         name="red-diffuse")
    pos = np.array([[-1, -0.5, 0], [1, -0.5, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (3, 1))
    uv = np.array([[0, 1], [1, 1], [0.5, 0]], np.float32)
    b.add_node(mesh=b.add_mesh(pos, nrm, uv, np.arange(3), mat))
    b.add_node(camera=b.add_camera(yfov=np.deg2rad(45)),
               translation=[0, 0.2, 3])
    b.set_sky((0.5, 0.7, 1.0))
    return b.tobytes()


def cube_scene_glb() -> bytes:
    """BASELINE config 2: diffuse floor + metallic cube + emissive quad,
    multi-bounce, sky_color env."""
    b = GlbBuilder()
    floor_m = b.add_material(base_color=(0.6, 0.6, 0.6), metallic=0.0,
                             name="floor")
    cube_m = b.add_material(base_color=(0.8, 0.7, 0.3), metallic=1.0,
                            roughness=0.15, name="gold")
    light_m = b.add_material(base_color=(1, 1, 1), metallic=0.0,
                             emissive=(1.0, 0.9, 0.7), emissive_strength=5.0,
                             name="light")

    p, n, uv, idx = _quad((0, 0, 0), 4.0, axis=1)
    b.add_node(mesh=b.add_mesh(p, n, uv, idx, floor_m))

    # cube: 12 triangles
    v = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (0, 1)
                  for z in (-0.5, 0.5)], np.float32)
    faces = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ], np.uint32)
    ctr = v.mean(0)
    nrm = v - ctr
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    # Raised 1mm off the floor: exactly-coplanar triangles make the
    # closest-hit winner an FP tie, which different (all correct)
    # traversal orders resolve differently.
    b.add_node(mesh=b.add_mesh(v, nrm.astype(np.float32),
                               np.zeros((8, 2), np.float32),
                               faces.reshape(-1), cube_m),
               translation=[0, 0.001, 0])

    p, n, uv, idx = _quad((0, 2.5, 0), 1.0, axis=1)
    n = -n
    b.add_node(mesh=b.add_mesh(p, n, uv, idx, light_m))

    b.add_node(camera=b.add_camera(yfov=np.deg2rad(50)),
               translation=[0, 1.2, 4],
               rotation=_quat_from_euler_x(-0.15))
    b.set_sky((0.4, 0.5, 0.8), strength=0.6)
    return b.tobytes()


def dielectric_scene_glb(subdiv=1) -> bytes:
    """BASELINE config 3: glass sphere (IOR + transmission) over a
    diffuse floor with an emissive panel."""
    b = GlbBuilder()
    floor_m = b.add_material(base_color=(0.5, 0.55, 0.6), metallic=0.0,
                             name="floor")
    glass_m = b.add_material(base_color=(1, 1, 1), metallic=0.0,
                             ior=1.5, transmission=1.0, name="glass")
    light_m = b.add_material(base_color=(1, 1, 1),
                             emissive=(1.0, 1.0, 1.0), emissive_strength=8.0,
                             name="light")

    p, n, uv, idx = _quad((0, -1.0, 0), 6.0, axis=1)
    b.add_node(mesh=b.add_mesh(p, n, uv, idx, floor_m))

    sv, sn, suv, sidx = _icosphere(radius=1.0, subdiv=subdiv)
    b.add_node(mesh=b.add_mesh(sv, sn, suv, sidx, glass_m),
               translation=[0, 0.2, 0])

    p, n, uv, idx = _quad((2.0, 2.0, 0), 0.8, axis=1)
    n = -n
    b.add_node(mesh=b.add_mesh(p, n, uv, idx, light_m))

    b.add_node(camera=b.add_camera(yfov=np.deg2rad(45)),
               translation=[0, 0.6, 4.5])
    b.set_sky((0.7, 0.8, 1.0))
    return b.tobytes()


def textured_scene_glb() -> bytes:
    """Diffuse quad with a checkerboard baseColorTexture."""
    b = GlbBuilder()
    check = np.zeros((64, 64, 4), np.uint8)
    check[..., 3] = 255
    yy, xx = np.mgrid[0:64, 0:64]
    m = ((xx // 8) + (yy // 8)) % 2 == 0
    check[m] = [255, 40, 40, 255]
    check[~m] = [40, 40, 255, 255]
    tex = b.add_texture_png(encode_png(check))

    mat = b.add_material(base_color=(1, 1, 1), metallic=0.0,
                         base_color_texture=tex, name="checker")
    p, n, uv, idx = _quad((0, 0, 0), 1.0, axis=2)
    b.add_node(mesh=b.add_mesh(p, n, uv, idx, mat))
    b.add_node(camera=b.add_camera(yfov=np.deg2rad(45)),
               translation=[0, 0, 3])
    b.set_sky((1.0, 1.0, 1.0))
    return b.tobytes()


def _resize_texture(w: int, h: int, channels: int, seed: int) -> np.ndarray:
    """[h, w, channels] uint8: two gradients, a checker and seeded noise,
    so that a resize to 512x512 both shrinks and stretches detail."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    np.where((xx // 16 + yy // 16) % 2 == 0, 230, 30),
                    96 + (xx * 7 + yy * 3) % 160], axis=-1)[..., :channels]
    img = img + rs.randint(-12, 13, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# The resized textures of resized_textures_glb: (width, height, channels)
RESIZED_TEXTURES = ((256, 256, 4), (1024, 1024, 4), (300, 700, 3))
# sha256 of each of its decoded textures ([512, 512, 4] uint8), pinned
# against the Pillow resize of the JAX package's decode_image_bytes
# (tests/test_torch_ingest.py); utils/gltf.py reaches them without Pillow.
RESIZED_TEXTURES_SHA256 = (
    "5a22d68f15751d1f8e422a352688b11bb4a28feed2cd0c3ed83a5ee3f002db34",
    "0443736d19fd6ae4fff1ecda106cb151331a95f680ea0469ed0f609870c2d57f",
    "5f755d5500d49ec9d61f0e5b2347b934367c1f220e122c57154052dbc14c4806",
)


def resized_textures_glb() -> bytes:
    """Three diffuse quads side by side, each with a baseColorTexture
    that is not 512x512 (RESIZED_TEXTURES), under a lamp: the ingest
    resamples each to the atlas resolution."""
    b = GlbBuilder()
    for i, (w, h, c) in enumerate(RESIZED_TEXTURES):
        tex = b.add_texture_png(encode_png(_resize_texture(w, h, c, i)))
        mat = b.add_material(base_color=(1, 1, 1), metallic=0.0,
                             base_color_texture=tex, name=f"tex{w}x{h}")
        p, n, uv, idx = _quad((2.2 * (i - 1), 0, 0), 1.0, axis=2)
        b.add_node(mesh=b.add_mesh(p, n, uv, idx, mat))
    light_m = b.add_material(base_color=(1, 1, 1), emissive=(1, 1, 1),
                             emissive_strength=1.0, name="light")
    p, n, uv, idx = _quad((0, 3.0, 1.0), 2.0, axis=1)
    b.add_node(mesh=b.add_mesh(p, -n, uv, idx, light_m))
    b.add_node(camera=b.add_camera(yfov=np.deg2rad(40)),
               translation=[0, 0, 4.5])
    b.set_sky((0.6, 0.6, 0.7), strength=0.3)
    return b.tobytes()


def _quat_from_euler_x(rx: float):
    return [np.sin(rx / 2), 0.0, 0.0, np.cos(rx / 2)]


def instanced_scene_glb(r: int = 1000, seed: int = 5) -> bytes:
    """Instance-heavy fixture: r glTF NODES all referencing ONE
    12-triangle cube mesh, scattered on a grid with per-node TRS, plus
    a floor, a lamp and a camera. It is the minecraft-style workload
    the reference handles with one shared Embree BLAS + per-instance
    transforms (scene.cpp:435-439, 487-493): the port renders it baked
    (utils/gltf.py) or two-level (utils/instanced.py,
    models/instanced.py)."""
    rs = np.random.RandomState(seed)
    b = GlbBuilder()
    floor_m = b.add_material(base_color=(0.55, 0.55, 0.55),
                             name="floor")
    inst_m = b.add_material(base_color=(0.7, 0.45, 0.3),
                            metallic=0.2, roughness=0.5, name="block")
    light_m = b.add_material(base_color=(1, 1, 1),
                             emissive=(1.0, 0.95, 0.8),
                             emissive_strength=4.0, name="light")

    side = max(1.0, np.sqrt(r) * 1.6)
    p, n, uv, idx = _quad((0, 0, 0), side, axis=1)
    b.add_node(mesh=b.add_mesh(p, n, uv, idx, floor_m))

    v = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (0, 1)
                  for z in (-0.5, 0.5)], np.float32)
    faces = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ], np.uint32)
    ctr = v.mean(0)
    nrm = (v - ctr)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    cube = b.add_mesh(v, nrm.astype(np.float32),
                      np.zeros((8, 2), np.float32),
                      faces.reshape(-1), inst_m)

    g = int(np.ceil(np.sqrt(r)))
    for i in range(r):
        gx, gz = i % g, i // g
        tx = (gx - g / 2) * 1.5 + rs.uniform(-0.3, 0.3)
        tz = (gz - g / 2) * 1.5 + rs.uniform(-0.3, 0.3)
        ry = rs.uniform(0, np.pi)
        s = rs.uniform(0.4, 1.0)
        b.add_node(mesh=cube, translation=[tx, 0.001, tz],
                   rotation=[0.0, np.sin(ry / 2), 0.0, np.cos(ry / 2)],
                   scale=[s, s * rs.uniform(0.5, 2.0), s])

    p, n, uv, idx = _quad((0, 6.0, 0), 3.0, axis=1)
    b.add_node(mesh=b.add_mesh(p, -n, uv, idx, light_m))
    b.add_node(camera=b.add_camera(yfov=np.deg2rad(55)),
               translation=[0, 3.0, side * 0.55],
               rotation=_quat_from_euler_x(-0.35))
    b.set_sky((0.45, 0.55, 0.8), strength=0.5)
    return b.tobytes()


def straddler_scene(rays: int = 1000, seed: int = 1234):
    """Where SBVH spatial splits fire (the construction of
    tests/test_sah.py:121-131): 1,200 small random triangles and 80
    large ones that straddle split planes, then `rays` rays with origins
    in [-8, 8]^3 and directions in [-1, 1]^3, all from `seed`. Returns
    (tri_v [1280, 3, 3], o [rays, 3], d [rays, 3]), float32."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(-5.0, 5.0, (1200, 3)).astype(np.float32)
    small = c[:, None, :] + rs.uniform(-0.3, 0.3, (1200, 3, 3)).astype(
        np.float32)
    big = (rs.uniform(-5, 5, (80, 3, 3)) * 2.0).astype(np.float32)
    tri = np.concatenate([small, big]).astype(np.float32)
    o = rs.uniform(-8, 8, (rays, 3)).astype(np.float32)
    d = rs.uniform(-1, 1, (rays, 3)).astype(np.float32)
    return tri, o, d


def load_pair(glb_bytes, width, height, leaf_size=4, device="cuda",
              intersector="auto"):
    """(DeviceScene, HostScene, Camera) from GLB bytes, at the JAX
    package's test leaf size: its load_pair builds the Morton heap of
    4-triangle leaves, the path of its render gate. intersector="lbvh"
    builds the binary-LBVH cross-check tables instead."""
    from sycl_ray_tracer_torch.models.camera import make_camera
    from sycl_ray_tracer_torch.models.scene import build_device_scene
    from sycl_ray_tracer_torch.utils.gltf import load_glb

    host = load_glb(glb_bytes)
    scene = build_device_scene(host, leaf_size=leaf_size, device=device,
                               intersector=intersector)
    cam = make_camera(width, height, host.camera_position,
                      host.camera_direction, host.camera_focal_length,
                      device=device)
    return scene, host, cam
