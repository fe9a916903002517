"""The port's multi-device rendering (parallel/mesh.py) on the CPU: gloo
ranks spawned as separate processes (one spawn per world size runs
every case of that size), each rendering its share of samples and
pixels. Mirrors tests/test_parallel.py: the sharded frame equals the
port's single-device render to 1e-6 RMSE with equal per-bounce tallies,
on dp-only, sp-only and 2-D meshes, with both engines, on three scene
forms (the SAH tree, the Morton heap of leaf size 4 and two-level
instancing, which the JAX package's evidence lacks). On the heap scene
the sharded frames also pass the flip-tolerant gate against JAX
render_sharded on the 8-virtual-device mesh."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke

from sycl_ray_tracer_torch.models.camera import make_camera
from sycl_ray_tracer_torch.models.renderer import get_renderer
from sycl_ray_tracer_torch.parallel import mesh as pm
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils.cli import load_scene

from tests import torch_common  # noqa: F401  (thread count)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP, DEPTH = 32, 24, 4, 6
_SCENES = {
    "cube_sah": dict(glb="cube", leaf_size=8),
    "cube_heap": dict(glb="cube", leaf_size=4),
    "instanced": dict(glb=tfix.instanced_scene_glb(30),
                      shared_instances=True),
}
_MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
_ENGINES = ("wavefront", "megakernel")
_CASES = [(s, m, e) for s in _SCENES for world in _MESHES
          for m in _MESHES[world] for e in _ENGINES]


def _jobs(world):
    names = list(_SCENES)
    return [dict(scene=names.index(s), dp=m[0], sp=m[1], renderer=e,
                 width=W, height=H, spp=SPP, max_depth=DEPTH, seed=3)
            for s, m, e in _CASES if m[0] * m[1] == world]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{(scene, mesh, engine): (image, tallies)} from one spawn of 2
    gloo ranks and one of 4."""
    out = {}
    for world in _MESHES:
        tmp = tmp_path_factory.mktemp(f"world{world}")
        path = str(tmp / "out.pt")
        pm.spawn(chip_smoke.render_jobs, world, "gloo", ["cpu"] * world,
                 f"file://{tmp / 'store'}",
                 args=(list(_SCENES.values()), _jobs(world), path))
        res = torch.load(path)
        keys = [(s, m, e) for s, m, e in _CASES if m[0] * m[1] == world]
        for k, (img, rays, _, _) in zip(keys, res):
            out[k] = (img.numpy(), rays.numpy())
    return out


_SINGLE = {}


def _single(scene_name, engine):
    """The port's single-device render of a case, and its scene."""
    if scene_name not in _SINGLE:
        spec = dict(_SCENES[scene_name])
        glb = spec.pop("glb")
        glb = getattr(tfix, f"{glb}_scene_glb")() if isinstance(glb, str) \
            else glb
        scene, host = load_scene(glb, "cpu", spec.get("shared_instances",
                                                      False),
                                 leaf_size=spec.get("leaf_size", 8),
                                 log=lambda *a: None)
        cam = make_camera(W, H, host.camera_position, host.camera_direction,
                          host.camera_focal_length, device="cpu")
        _SINGLE[scene_name] = (scene, cam, {})
    scene, cam, imgs = _SINGLE[scene_name]
    if engine not in imgs:
        img, rays = get_renderer(engine)(scene, cam, width=W, height=H,
                                         spp=SPP, max_depth=DEPTH, seed=3)
        imgs[engine] = (img.numpy(), rays.numpy())
    return scene, cam, imgs[engine]


def _rmse(a, b):
    return float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2)))


@pytest.mark.parametrize("scene_name,mesh,engine", _CASES)
def test_sharded_equals_single(sharded, scene_name, mesh, engine):
    img, rays = sharded[(scene_name, mesh, engine)]
    _, _, (ref, ref_rays) = _single(scene_name, engine)
    assert img.shape == (H, W, 3) and rays.dtype == np.int64
    assert _rmse(img, ref) < 1e-6
    assert (rays == ref_rays).all(), (rays, ref_rays)
    assert rays[0] == W * H * SPP and img.max() > 0.1


@pytest.mark.parametrize("engine,mesh", [("wavefront", (2, 2)),
                                         ("megakernel", (1, 2))])
def test_heap_sharded_matches_jax_render_sharded(sharded, engine, mesh):
    """The heap scene (the JAX package's own test path, load_pair K = 4)
    against JAX render_sharded on the same dp x sp of the virtual-device
    mesh: the flip-tolerant gate and tallies within the flip tail."""
    from sycl_ray_tracer_tpu.parallel.mesh import make_mesh, render_sharded

    from tests import scenes
    from tests.test_render import check_oracle_match

    img, rays = sharded[("cube_heap", mesh, engine)]
    js, _, jcam = scenes.load_pair(scenes.cube_scene_glb(), W, H,
                                   leaf_size=4)
    jimg, jrays = render_sharded(js, jcam, width=W, height=H, spp=SPP,
                                 max_depth=DEPTH, seed=3,
                                 mesh=make_mesh(dp=mesh[0], sp=mesh[1]),
                                 renderer=engine)
    check_oracle_match(img, np.asarray(jimg))
    jrays = np.asarray(jrays).astype(np.int64)
    assert (np.abs(rays - jrays) <= np.maximum(16, 0.005 * jrays)).all(), (
        rays, jrays)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 's'}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("scene_name", list(_SCENES))
def test_world_of_one_is_the_single_render(world_of_one, scene_name):
    """A 1x1 mesh reduces one rank's frame: bit-equal to render_*."""
    for engine in _ENGINES:
        scene, cam, (ref, ref_rays) = _single(scene_name, engine)
        img, rays = pm.render_sharded(scene, cam, width=W, height=H,
                                      spp=SPP, max_depth=DEPTH, seed=3,
                                      renderer=engine)
        assert np.array_equal(img.numpy(), ref)
        assert (rays.numpy() == ref_rays).all()


def test_mesh_placement_and_size(world_of_one):
    m = pm.make_mesh()
    assert (m.dp, m.sp, m.coords()) == (1, 1, (0, 0))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pm.make_mesh(dp=2)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        pm.make_mesh(dp=2, sp=2)


@pytest.mark.parametrize("dp,sp,spp,match", [
    (2, 1, 3, r"spp=3 must divide by dp=2"),
    (1, 5, 4, r"pixels=768 must divide by sp=5"),
])
def test_render_sharded_refuses_uneven_shards(dp, sp, spp, match):
    scene, cam, _ = _single("cube_sah", "wavefront")
    with pytest.raises(ValueError, match=match):
        pm.render_sharded(scene, cam, width=W, height=H, spp=spp,
                          max_depth=DEPTH, mesh=pm.Mesh(dp, sp))


def test_render_sharded_refuses_unknown_renderer():
    scene, cam, _ = _single("cube_sah", "wavefront")
    with pytest.raises(ValueError, match="unknown renderer"):
        pm.render_sharded(scene, cam, width=W, height=H, spp=SPP,
                          max_depth=DEPTH, mesh=pm.Mesh(1, 1),
                          renderer="bidirectional")


def test_cli_devices_on_the_cpu(tmp_path):
    """--device cpu --devices 2: two gloo ranks, rank 0 prints the
    contract lines once and writes the image; the rays are the single
    render's."""
    from sycl_ray_tracer_torch.utils.png import decode_png

    out = tmp_path / "img.png"
    env = dict(os.environ, PYTHONPATH=_ROOT)
    p = subprocess.run(
        [sys.executable, "-m", "sycl_ray_tracer_torch", "cube", "--device",
         "cpu", "--devices", "2", "-s", "4", "-d", "6", "--width", "32",
         "--height", "24", "--seed", "3", "-o", str(out)], cwd=_ROOT,
        env=env, capture_output=True, text=True, timeout=180)
    assert p.returncode == 0, p.stderr
    assert p.stdout.count("Time measured") == 1, p.stdout
    lines = p.stdout.splitlines()
    i = next(k for k, ln in enumerate(lines)
             if ln.startswith("Time measured"))
    assert re.fullmatch(r"Time measured: \d+\.\d{6} seconds", lines[i])
    m = re.fullmatch(r"Total rays: (\d+)", lines[i + 1])
    assert re.fullmatch(r"Rays/sec: \d+\.\d\dM", lines[i + 2])
    _, _, (ref, ref_rays) = _single("cube_sah", "wavefront")
    assert int(m.group(1)) == int(ref_rays.sum())
    got = decode_png(out.read_bytes())[..., :3].astype(np.int64)
    want = np.clip(ref * 255, 0, 255).astype(np.int64)
    assert np.abs(got - want).max() <= 1
