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


def _quat_from_euler_x(rx: float):
    return [np.sin(rx / 2), 0.0, 0.0, np.cos(rx / 2)]
