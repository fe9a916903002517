"""A voxel world in the shapes of a Minecraft export, rendered two-level.

upstream's minecraft.glb (benchmark.py's second scene) is a block world
that the renderer takes in as Embree instances: one BLAS per primitive
and one TLAS of its node x primitive instances (scene.cpp:404-439). The
file is not distributed, so this module builds a world with its shapes:

- a 360 x 360 column heightmap of 1-m blocks (relief 0-12 m), one block
  per voxel;
- each solid block a node instancing the unit box of its material, one
  box mesh per material (grass, dirt and stone textured with images of
  512 x 512; iron, metal; glowstone, emissive);
- the visible shell only, as a world exporter keeps it: a column holds
  its surface block and the blocks below it down to its lowest
  neighbour's surface, so no cliff shows a hole;
- water as one mesh of its exposed faces, as exporters write it: no
  face between two water voxels, nor between water and a solid block;
- iron and glowstone each on about 1 % of the surface blocks.

The camera looks over the terrain from `height` metres above its top,
pitched down by `pitch` radians; the two set how many rays a path
traces (configs/minecraft_vox.json). Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

from srt_bench.scenes.glb_writer import GlbBuilder
from srt_bench.scenes.procgen import _box, _texture_png

AIR, SOLID, WATER = 0, 1, 2
# the solid blocks' materials, in the GLB's order of materials
GRASS, DIRT, STONE, IRON, GLOWSTONE = range(5)

# the six neighbours of a voxel (dx, dy, dz) and each face's corners in
# the unit cube [0, 1]^3, counter-clockwise seen from outside
_FACES = (
    ((-1, 0, 0), ((0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0))),
    ((1, 0, 0), ((1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1))),
    ((0, -1, 0), ((0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1))),
    ((0, 1, 0), ((0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0))),
    ((0, 0, -1), ((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0))),
    ((0, 0, 1), ((0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))),
)


def heightmap(n: int, rs: np.random.RandomState, relief: float = 12.0,
              lattice: int = 4) -> np.ndarray:
    """[n, n] int surface heights in 0..relief: value noise on a lattice
    of `lattice` columns, bilinear, rounded (z rows, x columns)."""
    coarse = rs.uniform(0, relief, (n // lattice + 2, n // lattice + 2))
    ys, xs = np.mgrid[0:n, 0:n] / float(lattice)
    x0, y0 = xs.astype(int), ys.astype(int)
    fx, fy = xs - x0, ys - y0
    h = (coarse[y0, x0] * (1 - fx) * (1 - fy)
         + coarse[y0, x0 + 1] * fx * (1 - fy)
         + coarse[y0 + 1, x0] * (1 - fx) * fy
         + coarse[y0 + 1, x0 + 1] * fx * fy)
    return np.round(h).astype(np.int64)


def world(n: int = 360, seed: int = 3, water_level: int = 5):
    """(grid, material, h): grid [n, Y, n] uint8 of AIR / SOLID / WATER
    indexed [z, y, x]; material [n, Y, n] int8, the material (GRASS ..
    GLOWSTONE) of each solid voxel (-1 elsewhere); h the heightmap. A
    column holds its surface block at y = h and the blocks below it down
    to one above its lowest neighbour's surface; water fills the voxels
    above the surface and below water_level. Land surfaces (no water
    above) are grass on three blocks of dirt, lake beds stone."""
    rs = np.random.RandomState(seed)
    h = heightmap(n, rs)
    ny = int(max(h.max(), water_level)) + 2
    pad = np.pad(h, 1, mode="edge")
    lowest = np.minimum.reduce([pad[:-2, 1:-1], pad[2:, 1:-1],
                                pad[1:-1, :-2], pad[1:-1, 2:]])
    floor = np.minimum(h, lowest + 1)
    y = np.arange(ny)[None, :, None]
    hh, ff = h[:, None, :], floor[:, None, :]
    grid = np.zeros((n, ny, n), np.uint8)
    solid = (y >= ff) & (y <= hh)
    grid[solid] = SOLID
    grid[(y > hh) & (y < water_level)] = WATER
    land = h >= water_level - 1
    mat = np.full((n, ny, n), -1, np.int8)
    under = np.where(land[:, None, :] & (y >= hh - 3), DIRT, STONE)
    mat[solid] = under[solid]
    top = np.where(land, GRASS, STONE)
    r = rs.rand(n, n)
    top = np.where(r < 0.02, IRON, top)
    top = np.where(r < 0.01, GLOWSTONE, top)
    zz, xx = np.mgrid[0:n, 0:n]
    mat[zz, h, xx] = top
    return grid, mat, h


def water_faces(grid: np.ndarray) -> np.ndarray:
    """[F, 4, 3] corners (voxel units, [z, y, x] grid to x, y, z) of the
    water's exposed faces: those of a water voxel whose neighbour is air
    or outside the grid. Faces between two water voxels and between
    water and a solid block are not written."""
    n_z, n_y, n_x = grid.shape
    out = []
    wz, wy, wx = np.nonzero(grid == WATER)
    for (dx, dy, dz), corners in _FACES:
        nz, ny_, nx = wz + dz, wy + dy, wx + dx
        inside = ((nz >= 0) & (nz < n_z) & (ny_ >= 0) & (ny_ < n_y)
                  & (nx >= 0) & (nx < n_x))
        nb = np.zeros(wz.shape, np.uint8)
        nb[inside] = grid[nz[inside], ny_[inside], nx[inside]]
        keep = nb == AIR
        base = np.stack([wx[keep], wy[keep], wz[keep]], 1).astype(np.float64)
        out.append(base[:, None, :] + np.asarray(corners, np.float64)[None])
    return np.concatenate(out) if out else np.zeros((0, 4, 3))


def _water_mesh(faces: np.ndarray, n: int):
    """The water's faces as one mesh in world space: quads of two
    triangles, each with its face's normal and the unit square's UVs.
    Voxel x, z are centred as the boxes' nodes are (x - n / 2)."""
    f = faces.astype(np.float64).copy()
    f[..., 0] -= n / 2 + 0.5
    f[..., 2] -= n / 2 + 0.5
    e1 = f[:, 1] - f[:, 0]
    e2 = f[:, 2] - f[:, 0]
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    verts = f.reshape(-1, 3).astype(np.float32)
    normals = np.repeat(nrm, 4, axis=0).astype(np.float32)
    uvs = np.tile(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                  (f.shape[0], 1))
    base = (np.arange(f.shape[0]) * 4)[:, None]
    idx = np.concatenate([base + [0, 1, 2], base + [0, 2, 3]], 1)
    return verts, normals, uvs, idx.astype(np.uint32).reshape(-1)


def voxel_world_glb(n: int = 360, seed: int = 3, water_level: int = 5,
                    pitch: float = 0.6, height: float = 14.0) -> bytes:
    """The GLB bytes of the world (see the module docstring): its solid
    blocks as nodes in z, x, y order, then the water mesh's node, then
    the camera at (0, top + height, n / 2 + 8) pitched down by
    `pitch`."""
    grid, mat, h = world(n, seed, water_level)
    b = GlbBuilder()
    tex = {name: b.add_texture_png(_texture_png(rgb, kind, 200 + i))
           for i, (name, rgb, kind) in enumerate([
               ("grass", (0.25, 0.55, 0.2), "noise"),
               ("dirt", (0.45, 0.32, 0.2), "noise"),
               ("stone", (0.5, 0.5, 0.52), "stone"),
           ])}
    mats = [
        b.add_material(base_color=(0.25, 0.55, 0.2), name="grass",
                       base_color_texture=tex["grass"]),
        b.add_material(base_color=(0.45, 0.32, 0.2), name="dirt",
                       base_color_texture=tex["dirt"]),
        b.add_material(base_color=(0.5, 0.5, 0.52), name="stone",
                       base_color_texture=tex["stone"]),
        b.add_material(base_color=(0.8, 0.8, 0.85), metallic=1.0,
                       roughness=0.3, name="iron"),
        b.add_material(base_color=(1, 1, 1), emissive=(1.0, 0.85, 0.5),
                       emissive_strength=4.0, name="glowstone"),
    ]
    water_m = b.add_material(ior=1.33, transmission=1.0, name="water")
    box = _box((1.0, 1.0, 1.0))
    meshes = [b.add_mesh(*box, m) for m in mats]

    zs, xs, ys = np.nonzero(grid.transpose(0, 2, 1) == SOLID)
    kinds = mat.transpose(0, 2, 1)[zs, xs, ys]
    for z, x, y, k in zip(zs.tolist(), xs.tolist(), ys.tolist(),
                          kinds.tolist()):
        b.add_node(mesh=meshes[k], translation=[x - n / 2, float(y),
                                                z - n / 2])
    faces = water_faces(grid)
    if faces.shape[0]:
        b.add_node(mesh=b.add_mesh(*_water_mesh(faces, n), water_m))

    b.add_node(camera=b.add_camera(yfov=np.deg2rad(60)),
               translation=[0, float(h.max() + height), n / 2 + 8],
               rotation=[float(np.sin(-pitch / 2)), 0, 0,
                         float(np.cos(-pitch / 2))])
    b.set_sky((0.55, 0.7, 1.0))
    return b.tobytes()
