"""Procedural benchmark scenes.

The reference benchmarks on sponza.glb (262K triangles, an atrium with
heavy occlusion) and minecraft.glb (axis-aligned voxel world), neither
of which is distributed with it (.gitignore:4). These generators build
scenes with the same structural character — deterministic, size-
parameterized, written through the real GLB pipeline so the benchmark
exercises ingest too.
"""

from __future__ import annotations

import numpy as np

from sycl_ray_tracer_torch.utils.glb_writer import GlbBuilder
from sycl_ray_tracer_torch.utils.png import encode_png


def _value_noise(rs, res: int, cell: int) -> np.ndarray:
    """Tileable bilinear value noise in [0, 1], res x res."""
    g = rs.uniform(0, 1, (res // cell + 1, res // cell + 1))
    g[-1, :] = g[0, :]   # tileable
    g[:, -1] = g[:, 0]
    ys, xs = np.mgrid[0:res, 0:res] / float(cell)
    x0, y0 = xs.astype(int), ys.astype(int)
    fx, fy = xs - x0, ys - y0
    fx = fx * fx * (3 - 2 * fx)  # smoothstep
    fy = fy * fy * (3 - 2 * fy)
    return (g[y0, x0] * (1 - fx) * (1 - fy)
            + g[y0, x0 + 1] * fx * (1 - fy)
            + g[y0 + 1, x0] * (1 - fx) * fy
            + g[y0 + 1, x0 + 1] * fx * fy)


def _texture_png(base_rgb, kind: str, seed: int, res: int = 512) -> bytes:
    """Procedural tileable texture around base_rgb.

    The reference's Sponza is heavily textured (image_manager.hpp
    uploads every glTF image; material.hpp:45-53 samples base color per
    bounce), so the benchmark scenes carry real images too — the
    in-loop atlas gather is part of every measured number."""
    rs = np.random.RandomState(seed)
    base = np.asarray(base_rgb, np.float32)
    n1 = _value_noise(rs, res, 64)
    n2 = _value_noise(rs, res, 16)
    n3 = _value_noise(rs, res, 4)
    if kind == "stone":
        v = 0.75 + 0.3 * n1 + 0.15 * n2 + 0.08 * n3 - 0.25
        yy, xx = np.mgrid[0:res, 0:res]
        mortar = ((yy % (res // 4) < 3)
                  | ((xx + (yy // (res // 4)) * res // 8)
                     % (res // 2) < 3))
        v = np.where(mortar, v * 0.55, v)
    elif kind == "marble":
        yy = np.mgrid[0:res, 0:res][0] / res
        v = 0.8 + 0.25 * np.sin((yy * 6 + 3.5 * n1) * 2 * np.pi)
        v += 0.1 * n3 - 0.05
    elif kind == "cloth":
        yy, xx = np.mgrid[0:res, 0:res]
        weave = 0.12 * (np.sin(xx * 2 * np.pi * 32 / res)
                        * np.sin(yy * 2 * np.pi * 32 / res))
        v = 0.85 + weave + 0.2 * n2
    else:  # "noise"
        v = 0.7 + 0.4 * n1 + 0.15 * n3
    rgb = np.clip(base[None, None, :] * v[..., None], 0, 1)
    img = np.concatenate(
        [(rgb * 255).astype(np.uint8),
         np.full((res, res, 1), 255, np.uint8)], axis=-1)
    return encode_png(img)


def _cylinder(radius, height, sides, segs):
    """Open cylinder wall: sides*segs*2 triangles."""
    ang = np.linspace(0, 2 * np.pi, sides, endpoint=False)
    ring = np.stack([np.cos(ang), np.zeros_like(ang), np.sin(ang)], 1)
    verts, normals, uvs, faces = [], [], [], []
    for s in range(segs + 1):
        y = height * s / segs
        verts.append(ring * radius + np.array([0, y, 0]))
        normals.append(ring)
        uvs.append(np.stack([ang / (2 * np.pi),
                             np.full_like(ang, s / segs)], 1))
    verts = np.concatenate(verts).astype(np.float32)
    normals = np.concatenate(normals).astype(np.float32)
    uvs = np.concatenate(uvs).astype(np.float32)
    for s in range(segs):
        for i in range(sides):
            a = s * sides + i
            b = s * sides + (i + 1) % sides
            c = a + sides
            d = b + sides
            faces += [[a, b, d], [a, d, c]]
    return verts, normals, uvs, np.asarray(faces, np.uint32).reshape(-1)


def _box(size):
    sx, sy, sz = size
    v = np.array([[x, y, z]
                  for x in (-sx / 2, sx / 2)
                  for y in (0, sy)
                  for z in (-sz / 2, sz / 2)], np.float32)
    quads = [  # (indices, normal)
        ((0, 1, 3, 2), (-1, 0, 0)), ((4, 6, 7, 5), (1, 0, 0)),
        ((0, 4, 5, 1), (0, 0, -1)), ((2, 3, 7, 6), (0, 0, 1)),
        ((0, 2, 6, 4), (0, -1, 0)), ((1, 5, 7, 3), (0, 1, 0)),
    ]
    verts, normals, uvs, faces = [], [], [], []
    for qi, (idx, n) in enumerate(quads):
        base = len(verts)
        for k in idx:
            verts.append(v[k])
            normals.append(n)
        uvs += [[0, 0], [1, 0], [1, 1], [0, 1]]
        faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return (np.asarray(verts, np.float32), np.asarray(normals, np.float32),
            np.asarray(uvs, np.float32),
            np.asarray(faces, np.uint32).reshape(-1))


def _icosphere(radius, subdiv):
    from sycl_ray_tracer_torch.utils.fixtures import _icosphere as ico
    return ico(radius=radius, subdiv=subdiv)


def sponza_like_glb(scale: int = 2, seed: int = 0) -> bytes:
    """Atrium: floor + walls + two-story colonnade + scattered clutter.

    scale=2 -> ~260K triangles (matches real Sponza's 262K scale);
    scale=1 -> ~65K for quicker runs.
    """
    rs = np.random.RandomState(seed)
    b = GlbBuilder()

    # textured like the real Sponza: every major diffuse surface
    # samples a base-color image per bounce (material.hpp:45-53)
    tex = {name: b.add_texture_png(_texture_png(rgb, kind, 100 + i))
           for i, (name, rgb, kind) in enumerate([
               ("floor", (0.55, 0.5, 0.45), "stone"),
               ("wall", (0.6, 0.55, 0.5), "stone"),
               ("wall2", (0.62, 0.56, 0.48), "noise"),
               ("column", (0.7, 0.68, 0.62), "marble"),
               ("slab", (0.66, 0.64, 0.6), "marble"),
               ("cloth0", (0.7, 0.15, 0.15), "cloth"),
               ("cloth1", (0.15, 0.5, 0.15), "cloth"),
               ("cloth2", (0.15, 0.2, 0.6), "cloth"),
           ])}
    floor_m = b.add_material(base_color=(0.55, 0.5, 0.45), name="floor",
                             base_color_texture=tex["floor"])
    wall_m = b.add_material(base_color=(0.6, 0.55, 0.5), name="wall",
                            base_color_texture=tex["wall"])
    col_m = b.add_material(base_color=(0.7, 0.68, 0.62), name="column",
                           base_color_texture=tex["column"])
    slab_m = b.add_material(base_color=(0.66, 0.64, 0.6), name="slab",
                            base_color_texture=tex["slab"])
    gold_m = b.add_material(base_color=(0.9, 0.75, 0.3), metallic=1.0,
                            roughness=0.2, name="gold")
    rough_metal_m = b.add_material(base_color=(0.6, 0.6, 0.65), metallic=1.0,
                                   roughness=0.6, name="steel")
    glass_m = b.add_material(ior=1.5, transmission=1.0, name="glass")
    cloth_ms = [b.add_material(base_color=tuple(c), name=f"cloth{i}",
                               base_color_texture=tex[f"cloth{i}"])
                for i, c in enumerate([(0.7, 0.15, 0.15), (0.15, 0.5, 0.15),
                                       (0.15, 0.2, 0.6)])]
    light_m = b.add_material(base_color=(1, 1, 1), emissive=(1, 0.95, 0.8),
                             emissive_strength=6.0, name="lamp")

    hall_w, hall_h, hall_d = 24.0, 12.0, 60.0

    def add_quad(p0, p1, p2, p3, normal, mat):
        verts = np.asarray([p0, p1, p2, p3], np.float32)
        normals = np.tile(np.asarray(normal, np.float32), (4, 1))
        uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        faces = np.asarray([0, 1, 2, 0, 2, 3], np.uint32)
        b.add_node(mesh=b.add_mesh(verts, normals, uvs, faces, mat))

    w2, d2 = hall_w / 2, hall_d / 2
    add_quad((-w2, 0, -d2), (w2, 0, -d2), (w2, 0, d2), (-w2, 0, d2),
             (0, 1, 0), floor_m)
    add_quad((-w2, 0, -d2), (-w2, hall_h, -d2), (-w2, hall_h, d2),
             (-w2, 0, d2), (1, 0, 0), wall_m)
    add_quad((w2, 0, -d2), (w2, 0, d2), (w2, hall_h, d2), (w2, hall_h, -d2),
             (-1, 0, 0), wall_m)
    back_m = b.add_material(base_color=(0.62, 0.56, 0.48), name="back",
                            base_color_texture=tex["wall2"])
    add_quad((-w2, 0, -d2), (w2, 0, -d2), (w2, hall_h, -d2),
             (-w2, hall_h, -d2), (0, 0, 1), back_m)

    # colonnades: two rows x two stories of fluted columns
    sides = 24 * scale
    segs = 6 * scale
    cv, cn, cu, ci = _cylinder(0.45, 4.5, sides, segs)
    col_mesh = b.add_mesh(cv, cn, cu, ci, col_m)
    n_cols = 12 * scale
    zs = np.linspace(-d2 + 3, d2 - 3, n_cols)
    for z in zs:
        for x in (-w2 + 3.0, w2 - 3.0):
            for y in (0.0, 5.5):
                b.add_node(mesh=col_mesh, translation=[x, y, float(z)])

    # story separator balconies along each wall; the center stays open
    # to the sky like Sponza's atrium
    bv, bn, bu, bi = _box((hall_w / 3.5, 0.6, hall_d))
    slab_mesh = b.add_mesh(bv, bn, bu, bi, slab_m)
    b.add_node(mesh=slab_mesh, translation=[-w2 + hall_w / 7, 4.7, 0])
    b.add_node(mesh=slab_mesh, translation=[w2 - hall_w / 7, 4.7, 0])

    # clutter: spheres and boxes with mixed materials
    sphere_meshes = {
        gold_m: b.add_mesh(*_icosphere(1.0, 2 + (scale > 1)), gold_m),
        glass_m: b.add_mesh(*_icosphere(1.0, 2 + (scale > 1)), glass_m),
        rough_metal_m: b.add_mesh(*_icosphere(1.0, 2 + (scale > 1)),
                                  rough_metal_m),
    }
    n_clutter = 60 * scale * scale
    mats = list(sphere_meshes)
    for i in range(n_clutter):
        x = rs.uniform(-w2 + 4.5, w2 - 4.5)
        z = rs.uniform(-d2 + 3, d2 - 3)
        r = rs.uniform(0.25, 0.8)
        if rs.rand() < 0.5:
            mesh = sphere_meshes[mats[rs.randint(len(mats))]]
            b.add_node(mesh=mesh, translation=[x, r, z],
                       scale=[r, r, r])
        else:
            m = cloth_ms[rs.randint(len(cloth_ms))]
            bw, bh, bd = rs.uniform(0.4, 1.6, 3)
            bv2, bn2, bu2, bi2 = _box((bw, bh, bd))
            b.add_node(mesh=b.add_mesh(bv2, bn2, bu2, bi2, m),
                       translation=[x, 0, z])

    # lamps under the balconies, two rows
    lv, ln, lu, li = _box((0.8, 0.15, 0.8))
    lamp_mesh = b.add_mesh(lv, ln, lu, li, light_m)
    for z in np.linspace(-d2 + 6, d2 - 6, 6):
        for x in (-w2 + hall_w / 7, w2 - hall_w / 7):
            b.add_node(mesh=lamp_mesh, translation=[x, 4.2, float(z)])

    b.add_node(camera=b.add_camera(yfov=np.deg2rad(60)),
               translation=[0, 2.2, d2 - 2.0])
    b.set_sky((0.6, 0.7, 0.9), strength=1.2)
    return b.tobytes()


def minecraft_like_glb(n: int = 360, seed: int = 3) -> bytes:
    """Voxel terrain: n x n columns of unit boxes (12 tris each) with a
    water plane, glass blocks, and glowstone lamps. The default n=360
    (~2.1M tris) matches the reference minecraft.glb's
    bigger-than-Sponza scale; n=72 (~82K tris) is the small variant
    used when a quick voxel scene is enough."""
    rs = np.random.RandomState(seed)
    b = GlbBuilder()
    tex = {name: b.add_texture_png(_texture_png(rgb, kind, 200 + i))
           for i, (name, rgb, kind) in enumerate([
               ("grass", (0.25, 0.55, 0.2), "noise"),
               ("dirt", (0.45, 0.32, 0.2), "noise"),
               ("stone", (0.5, 0.5, 0.52), "stone"),
           ])}
    grass_m = b.add_material(base_color=(0.25, 0.55, 0.2), name="grass",
                             base_color_texture=tex["grass"])
    dirt_m = b.add_material(base_color=(0.45, 0.32, 0.2), name="dirt",
                            base_color_texture=tex["dirt"])
    stone_m = b.add_material(base_color=(0.5, 0.5, 0.52), name="stone",
                             base_color_texture=tex["stone"])
    water_m = b.add_material(ior=1.33, transmission=1.0, name="water")
    glow_m = b.add_material(base_color=(1, 1, 1), emissive=(1.0, 0.85, 0.5),
                            emissive_strength=4.0, name="glowstone")
    iron_m = b.add_material(base_color=(0.8, 0.8, 0.85), metallic=1.0,
                            roughness=0.3, name="iron")

    bv, bn, bu, bi = _box((1.0, 1.0, 1.0))
    meshes = {m: b.add_mesh(bv, bn, bu, bi, m)
              for m in (grass_m, dirt_m, stone_m, glow_m, iron_m, water_m)}

    # value-noise heightmap
    coarse = rs.uniform(0, 6, (n // 8 + 2, n // 8 + 2))
    ys, xs = np.mgrid[0:n, 0:n] / 8.0
    x0 = xs.astype(int)
    y0 = ys.astype(int)
    fx = xs - x0
    fy = ys - y0
    h = (coarse[y0, x0] * (1 - fx) * (1 - fy)
         + coarse[y0, x0 + 1] * fx * (1 - fy)
         + coarse[y0 + 1, x0] * (1 - fx) * fy
         + coarse[y0 + 1, x0 + 1] * fx * fy)
    h = np.round(h).astype(int)

    water_level = 2
    for gz in range(n):
        for gx in range(n):
            height = int(h[gz, gx])
            x = gx - n / 2
            z = gz - n / 2
            if height < water_level:
                b.add_node(mesh=meshes[water_m],
                           translation=[x, float(water_level - 1), z])
                top = stone_m
            else:
                top = grass_m
            r = rs.rand()
            if r < 0.01:
                top = glow_m
            elif r < 0.02:
                top = iron_m
            b.add_node(mesh=meshes[top], translation=[x, float(height), z])
            if height >= water_level and rs.rand() < 0.25:
                b.add_node(mesh=meshes[dirt_m],
                           translation=[x, float(height - 1), z])

    b.add_node(camera=b.add_camera(yfov=np.deg2rad(60)),
               translation=[0, float(h.max() + 14), n / 2 + 8],
               rotation=[float(np.sin(-0.3)), 0, 0, float(np.cos(-0.3))])
    b.set_sky((0.55, 0.7, 1.0))
    return b.tobytes()
