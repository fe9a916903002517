"""The benchmark's stand-in for Crytek Sponza, with the published
scene's shapes where the renderer sees them.

The columns, balconies and clutter are procgen.sponza_like_glb's; the
hall is closed as Sponza's atrium is, with a front wall and a roof that
leaves open a court down the middle, through which alone the sky comes
in; walls, floor, roofs and balconies are meshes of tiles, not single
quads (at scale 2: 261,472 triangles, against Sponza's 262,267). The
materials are Sponza's kind: 24 textured diffuse materials, each with
its own 1024 x 1024 base-colour image, which the ingest resizes to the
renderer's 512 x 512 atlas as it resizes Sponza's; no lamp, no glass,
no metal. The sky is the only light.
"""

from __future__ import annotations

import numpy as np

from srt_bench.scenes.glb_writer import GlbBuilder
from srt_bench.scenes.png import encode_png
from srt_bench.scenes.procgen import _box, _cylinder, _icosphere

# (name, base colour, pattern) of each material, after the diffuse
# maps of Sponza's 24 textured materials
MATERIALS = [
    ("floor", (0.55, 0.5, 0.45), "stone"),
    ("bricks", (0.6, 0.55, 0.5), "stone"),
    ("background", (0.62, 0.56, 0.48), "noise"),
    ("arch", (0.64, 0.6, 0.54), "stone"),
    ("roof", (0.5, 0.38, 0.3), "noise"),
    ("ceiling", (0.66, 0.64, 0.6), "marble"),
    ("column_a", (0.7, 0.68, 0.62), "marble"),
    ("column_b", (0.68, 0.64, 0.58), "marble"),
    ("column_c", (0.72, 0.7, 0.66), "stone"),
    ("vase_hanging", (0.5, 0.45, 0.4), "noise"),
    ("vase_round", (0.6, 0.5, 0.4), "noise"),
    ("vase", (0.58, 0.52, 0.46), "marble"),
    ("vase_plant", (0.3, 0.45, 0.25), "noise"),
    ("leaf", (0.25, 0.5, 0.2), "noise"),
    ("fabric_a", (0.7, 0.15, 0.15), "cloth"),
    ("fabric_c", (0.15, 0.5, 0.15), "cloth"),
    ("fabric_d", (0.15, 0.2, 0.6), "cloth"),
    ("fabric_e", (0.7, 0.2, 0.2), "cloth"),
    ("fabric_f", (0.2, 0.55, 0.2), "cloth"),
    ("fabric_g", (0.2, 0.25, 0.65), "cloth"),
    ("details", (0.6, 0.58, 0.52), "stone"),
    ("flagpole", (0.45, 0.4, 0.35), "noise"),
    ("lion", (0.62, 0.6, 0.55), "marble"),
    ("chain", (0.35, 0.33, 0.32), "noise"),
]
TEXTURE_RES = 1024


def _ramp(res: int, cell: int) -> np.ndarray:
    """[res, res // cell + 1] weights of a tileable smoothstep
    interpolation between the knots of a lattice of step `cell`."""
    x = np.arange(res) / float(cell)
    i = x.astype(int)
    f = x - i
    f = f * f * (3 - 2 * f)
    w = np.zeros((res, res // cell + 1), np.float32)
    w[np.arange(res), i] = 1 - f
    w[np.arange(res), i + 1] = f
    return w


def _noise(rs, res: int, cell: int) -> np.ndarray:
    """Tileable value noise in [0, 1], res x res: a lattice of uniform
    knots, smoothstep-interpolated along each axis (two products)."""
    g = rs.uniform(0, 1, (res // cell + 1, res // cell + 1)).astype(
        np.float32)
    g[-1, :] = g[0, :]
    g[:, -1] = g[:, 0]
    w = _ramp(res, cell)
    return w @ g @ w.T


def _texture_png(rgb, kind: str, seed: int, res: int) -> bytes:
    """A res x res RGBA image of one of four patterns around rgb."""
    rs = np.random.RandomState(seed)
    n1, n2, n3 = (_noise(rs, res, max(res // k, 1)) for k in (8, 32, 128))
    yy, xx = np.mgrid[0:res, 0:res]
    if kind == "stone":
        v = 0.5 + 0.3 * n1 + 0.15 * n2 + 0.08 * n3
        mortar = ((yy % (res // 4) < 6)
                  | ((xx + (yy // (res // 4)) * res // 8) % (res // 2) < 6))
        v = np.where(mortar, v * 0.55, v)
    elif kind == "marble":
        v = 0.75 + 0.25 * np.sin((yy / res * 6 + 3.5 * n1) * 2 * np.pi)
        v = v + 0.1 * n3
    elif kind == "cloth":
        weave = 0.12 * (np.sin(xx * 2 * np.pi * 64 / res)
                        * np.sin(yy * 2 * np.pi * 64 / res))
        v = 0.85 + weave + 0.2 * n2
    else:  # "noise"
        v = 0.7 + 0.4 * n1 + 0.15 * n3
    rgb = np.clip(np.asarray(rgb, np.float32) * v[..., None], 0, 1)
    img = np.empty((res, res, 4), np.uint8)
    img[..., :3] = rgb * 255
    img[..., 3] = 255
    return encode_png(img, level=1)


TILE = 1.0  # the largest side of a wall's, floor's or roof's tiles


def _tiles(p0, p1, p3, normal):
    """The quad p0, p1, p1 + p3 - p0, p3 as a grid of tiles whose sides
    are at most TILE, two triangles a tile (Sponza's walls are meshes
    of small triangles, not single quads): positions, normals, uvs
    (0 to 1 over the quad) and indices for GlbBuilder.add_mesh."""
    p0, p1, p3 = (np.asarray(p, np.float64) for p in (p0, p1, p3))
    nu = max(1, int(np.ceil(np.linalg.norm(p1 - p0) / TILE)))
    nv = max(1, int(np.ceil(np.linalg.norm(p3 - p0) / TILE)))
    su, sv = np.meshgrid(np.arange(nu + 1) / nu, np.arange(nv + 1) / nv)
    su, sv = su.reshape(-1), sv.reshape(-1)
    verts = (p0 + su[:, None] * (p1 - p0) + sv[:, None] * (p3 - p0))
    normals = np.tile(np.asarray(normal, np.float32), (verts.shape[0], 1))
    uvs = np.stack([su, sv], 1)
    a = (np.arange(nv)[:, None] * (nu + 1) + np.arange(nu)[None, :])
    a = a.reshape(-1)
    faces = np.stack([a, a + 1, a + nu + 2, a, a + nu + 2, a + nu + 1], 1)
    return (verts.astype(np.float32), normals, uvs.astype(np.float32),
            faces.astype(np.uint32).reshape(-1))


def _box_faces(hx, hy, hz):
    """The six faces (p0, p1, p2, p3, outward normal) of a box of half
    widths hx, hz and height hy, standing on y = 0."""
    x0, x1, y0, y1, z0, z1 = -hx, hx, 0.0, hy, -hz, hz
    return [
        ((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0), (-1, 0, 0)),
        ((x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1), (1, 0, 0)),
        ((x0, y0, z0), (x0, y1, z0), (x1, y1, z0), (x1, y0, z0), (0, 0, -1)),
        ((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1), (0, 0, 1)),
        ((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1), (0, -1, 0)),
        ((x0, y1, z0), (x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (0, 1, 0)),
    ]


def sponza_atrium_glb(scale: int = 2, seed: int = 0, court: float = 2.4,
                      texture_res: int = TEXTURE_RES) -> bytes:
    """The closed, all-diffuse atrium, open to the sky along a court
    `court` wide down the middle of the roof. The geometry's draws are
    sponza_like_glb's (same seed, same order), so its columns and
    clutter are the same; the materials' draws come from seed + 1."""
    rs = np.random.RandomState(seed)
    pick = np.random.RandomState(seed + 1)
    b = GlbBuilder()
    m = {}
    for i, (name, rgb, kind) in enumerate(MATERIALS):
        tex = b.add_texture_png(_texture_png(rgb, kind, 300 + i,
                                             res=texture_res))
        m[name] = b.add_material(base_color=rgb, name=name,
                                 base_color_texture=tex)

    hall_w, hall_h, hall_d = 24.0, 12.0, 60.0
    w2, d2 = hall_w / 2, hall_d / 2
    gallery = hall_w / 3.5  # the balconies' width

    def add_quad(p0, p1, p2, p3, normal, mat, translation=None):
        b.add_node(mesh=b.add_mesh(*_tiles(p0, p1, p3, normal), mat),
                   translation=translation)

    add_quad((-w2, 0, -d2), (w2, 0, -d2), (w2, 0, d2), (-w2, 0, d2),
             (0, 1, 0), m["floor"])
    add_quad((-w2, 0, -d2), (-w2, hall_h, -d2), (-w2, hall_h, d2),
             (-w2, 0, d2), (1, 0, 0), m["bricks"])
    add_quad((w2, 0, -d2), (w2, 0, d2), (w2, hall_h, d2), (w2, hall_h, -d2),
             (-1, 0, 0), m["bricks"])
    add_quad((-w2, 0, -d2), (w2, 0, -d2), (w2, hall_h, -d2),
             (-w2, hall_h, -d2), (0, 0, 1), m["background"])
    add_quad((-w2, 0, d2), (-w2, hall_h, d2), (w2, hall_h, d2),
             (w2, 0, d2), (0, 0, -1), m["arch"])
    for x0, x1 in ((-w2, -court / 2), (court / 2, w2)):
        add_quad((x0, hall_h, -d2), (x0, hall_h, d2), (x1, hall_h, d2),
                 (x1, hall_h, -d2), (0, -1, 0), m["roof"])

    # colonnades: two rows x two stories of fluted columns, in turns of
    # Sponza's three column materials
    sides = 24 * scale
    segs = 6 * scale
    cv, cn, cu, ci = _cylinder(0.45, 4.5, sides, segs)
    col_meshes = [b.add_mesh(cv, cn, cu, ci, m[c])
                  for c in ("column_a", "column_b", "column_c")]
    n_cols = 12 * scale
    zs = np.linspace(-d2 + 3, d2 - 3, n_cols)
    k = 0
    for z in zs:
        for x in (-w2 + 3.0, w2 - 3.0):
            for y in (0.0, 5.5):
                b.add_node(mesh=col_meshes[k % 3],
                           translation=[x, y, float(z)])
                k += 1

    # the balconies: boxes of gallery x 0.6 x hall_d, tiled as the walls
    gx, gy = gallery / 2, 0.6
    for cx in (-w2 + hall_w / 7, w2 - hall_w / 7):
        for p0, p1, p2, p3, n in _box_faces(gx, gy, d2):
            add_quad(p0, p1, p2, p3, n, m["ceiling"],
                     translation=[cx, 4.7, 0])

    # clutter: round vases and plants, and boxes of fabric and stone
    sphere = _icosphere(1.0, 2 + (scale > 1))
    round_ms = [m[c] for c in ("vase_round", "vase", "vase_plant", "leaf")]
    sphere_meshes = [b.add_mesh(*sphere, mat) for mat in round_ms]
    box_ms = [m[c] for c in ("fabric_a", "fabric_c", "fabric_d", "fabric_e",
                             "fabric_f", "fabric_g", "details", "flagpole",
                             "lion", "chain")]
    n_clutter = 60 * scale * scale
    for i in range(n_clutter):
        x = rs.uniform(-w2 + 4.5, w2 - 4.5)
        z = rs.uniform(-d2 + 3, d2 - 3)
        r = rs.uniform(0.25, 0.8)
        if rs.rand() < 0.5:
            rs.randint(3)  # sponza_like_glb's draw of a material
            mesh = sphere_meshes[pick.randint(len(sphere_meshes))]
            b.add_node(mesh=mesh, translation=[x, r, z], scale=[r, r, r])
        else:
            rs.randint(3)
            bw, bh, bd = rs.uniform(0.4, 1.6, 3)
            bv2, bn2, bu2, bi2 = _box((bw, bh, bd))
            mat = box_ms[pick.randint(len(box_ms))]
            b.add_node(mesh=b.add_mesh(bv2, bn2, bu2, bi2, mat),
                       translation=[x, 0, z])

    # hanging vases under the balconies, where sponza_like_glb has lamps
    lv, ln, lu, li = _box((0.8, 0.15, 0.8))
    hang_mesh = b.add_mesh(lv, ln, lu, li, m["vase_hanging"])
    for z in np.linspace(-d2 + 6, d2 - 6, 6):
        for x in (-w2 + hall_w / 7, w2 - hall_w / 7):
            b.add_node(mesh=hang_mesh, translation=[x, 4.2, float(z)])

    b.add_node(camera=b.add_camera(yfov=np.deg2rad(60)),
               translation=[0, 2.2, d2 - 2.0])
    b.set_sky((0.6, 0.7, 0.9), strength=1.2)
    return b.tobytes()
