"""The voxel world of the minecraft_vox configuration
(scenes/voxels.py): one block per voxel, water written as its exposed
faces only, the configuration's stated sizes equal to what the reference
reads, a generator that its seed decides, and a module that loads
nothing of the program."""

import json
import os
import subprocess
import sys

import numpy as np

from srt_bench import cells, run
from srt_bench.reference import ingest
from srt_bench.scenes import voxels

SMALL = dict(n=40, seed=3, water_level=5)


def _config():
    with open(os.path.join(cells.HERE, "configs", "minecraft_vox.json")) as f:
        return json.load(f)


def _nodes(glb):
    """The glTF's (nodes with a mesh, meshes) as the reference reads
    them: every node under the scene's roots."""
    gltf, _ = ingest._container(glb)
    nodes = gltf["nodes"]
    seen, stack = [], list(gltf["scenes"][gltf.get("scene", 0)]["nodes"])
    while stack:
        i = stack.pop()
        seen.append(nodes[i])
        stack += nodes[i].get("children", [])
    return [n for n in seen if "mesh" in n], gltf["meshes"]


def _blocks(glb, n):
    """{(x, y, z) voxel: mesh} of the box instances (every mesh node but
    the water's, which has no translation)."""
    mesh_nodes, _ = _nodes(glb)
    out = {}
    for node in mesh_nodes:
        if "translation" not in node:
            continue
        x, y, z = node["translation"]
        key = (int(round(x + n / 2)), int(round(y)), int(round(z + n / 2)))
        assert key not in out, f"two blocks in voxel {key}"
        out[key] = node["mesh"]
    return out


def test_one_block_per_voxel():
    glb = voxels.voxel_world_glb(**SMALL)
    grid, mat, h = voxels.world(**SMALL)
    blocks = _blocks(glb, SMALL["n"])
    zs, ys, xs = np.nonzero(grid == voxels.SOLID)
    assert set(blocks) == set(zip(xs.tolist(), ys.tolist(), zs.tolist()))
    # water only where no block is, and a surface block in every column
    assert not ((grid == voxels.WATER) & (mat >= 0)).any()
    assert (grid == voxels.WATER).any()
    zz, xx = np.mgrid[0:SMALL["n"], 0:SMALL["n"]]
    assert (grid[zz, h, xx] == voxels.SOLID).all()


def test_water_is_its_exposed_faces_only():
    """Each quad of the water mesh separates a water voxel from air: no
    face lies between two water voxels, nor between water and a solid
    block; and every such face of the world is written."""
    glb = voxels.voxel_world_glb(**SMALL)
    grid, _, _ = voxels.world(**SMALL)
    n = SMALL["n"]
    mesh_nodes, meshes = _nodes(glb)
    water = [m for m in mesh_nodes if "translation" not in m]
    assert len(water) == 1
    s = ingest.load(glb)
    wet = s.tri_mat == s.tri_mat[-1]            # the water's node is last
    assert s.mtype[s.tri_mat[-1]] == ingest.MAT_DIELECTRIC
    v = s.tri_v[wet].reshape(-1, 2, 3, 3)       # quads of two triangles
    centre = v.reshape(-1, 6, 3).mean(1)
    e1 = v[:, 0, 1] - v[:, 0, 0]
    e2 = v[:, 0, 2] - v[:, 0, 0]
    normal = np.cross(e1, e2)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    # the voxels on either side, by their centres (x - n / 2, y + 0.5,
    # z - n / 2) as x, y, z indices
    centre_of = np.array([n / 2, -0.5, n / 2])
    inner = np.rint(centre - 0.5 * normal + centre_of).astype(int)
    outer = np.rint(centre + 0.5 * normal + centre_of).astype(int)
    nz, ny, nx = grid.shape

    def kind(q):
        ok = ((q >= 0) & (q < np.array([nx, ny, nz]))).all(1)
        k = np.zeros(q.shape[0], np.uint8)
        k[ok] = grid[q[ok, 2], q[ok, 1], q[ok, 0]]
        return k

    assert (kind(inner) == voxels.WATER).all()
    assert (kind(outer) == voxels.AIR).all()
    faces = {(tuple(a), tuple(b)) for a, b in zip(inner.tolist(),
                                                   outer.tolist())}
    assert len(faces) == v.shape[0]
    assert len(faces) == voxels.water_faces(grid).shape[0]


def test_config_sizes_are_what_the_reference_reads():
    c = _config()
    glb = cells.scene_bytes(c)
    mesh_nodes, meshes = _nodes(glb)
    assert sum(len(meshes[m["mesh"]]["primitives"])
               for m in mesh_nodes) == c["instances"]
    boxes = sum(1 for m in mesh_nodes if "translation" in m)
    assert boxes == c["box_instances"]
    assert sum(len(meshes[m["mesh"]]["primitives"])
               for m in mesh_nodes) == boxes + 1
    s = ingest.load(glb)
    assert s.tri_v.shape[0] == c["world_triangles"]
    assert s.textures.shape == (3, 512, 512, 4)
    # every material kind: textured diffuse, metal, glass and emission
    used = np.unique(s.tri_mat)
    assert {ingest.MAT_DIFFUSE, ingest.MAT_METALLIC,
            ingest.MAT_DIELECTRIC} <= set(s.mtype[used].tolist())
    assert (s.emissive[used] > 0).any()
    # iron and glowstone each on about 1 % of the surface blocks
    per = np.bincount(s.tri_mat, minlength=len(s.mtype)) // 12
    surfaces = c["generator"]["args"]["n"] ** 2
    for kind in (voxels.IRON, voxels.GLOWSTONE):
        assert 0.008 < per[kind] / surfaces < 0.012


def test_generator_is_decided_by_its_seed():
    a = voxels.voxel_world_glb(**SMALL)
    assert voxels.voxel_world_glb(**SMALL) == a
    assert voxels.voxel_world_glb(**dict(SMALL, seed=4)) != a


def test_voxels_load_nothing_of_the_program():
    code = ("import sys\nimport srt_bench.scenes.voxels\n"
            "srt_bench.scenes.voxels.voxel_world_glb(n=8)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "sycl_ray_tracer_torch" not in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_pitch_sets_the_camera():
    """The camera looks down by `pitch` radians."""
    for p in (0.2, 0.4):
        s = ingest.load(voxels.voxel_world_glb(n=16, pitch=p))
        assert np.allclose(s.cam_dir / np.linalg.norm(s.cam_dir),
                           [0, -np.sin(p), -np.cos(p)], atol=1e-6)
