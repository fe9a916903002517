"""The port's megakernel (models/megakernel.py) on the JAX package's
render gate (tests/test_render.py:_render_all): both port engines on
the Morton-heap scenes of load_pair (leaf_size=4, traverse1) against
the JAX numpy oracle, against each other (float noise, equal tallies),
and the megakernel's tallies against JAX render_megakernel on the CPU;
plus max_depth = 0, the wave cut, the renderer registry and the CLI."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sycl_ray_tracer_tpu.models.megakernel import render_megakernel as jmk
from sycl_ray_tracer_tpu.models.oracle import render_oracle, rmse
from sycl_ray_tracer_torch.models import megakernel as mk
from sycl_ray_tracer_torch.models.renderer import get_renderer
from sycl_ray_tracer_torch.models.wavefront import render_wavefront
from sycl_ray_tracer_torch.ops import traverse1 as t1
from sycl_ray_tracer_torch.utils import fixtures as tfix

from tests import scenes
from tests.test_render import check_oracle_match

torch.set_num_threads(2)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def render_all(name, width, height, spp, max_depth, rr=False):
    """Port megakernel and wavefront on the port's load_pair scene
    (leaf_size=4), the JAX oracle and JAX render_megakernel on the JAX
    load_pair scene; checks the gate and returns the port images."""
    kw = dict(width=width, height=height, spp=spp, max_depth=max_depth,
              seed=0, rr=rr)
    scene, _, cam = tfix.load_pair(getattr(tfix, name)(), width, height,
                                   device="cpu")
    assert scene.has_heap and scene.leaf_size == 4
    before = t1.traverse1.launches
    m, mrays = mk.render_megakernel(scene, cam, **kw)
    w, wrays = render_wavefront(scene, cam, **kw)
    assert t1.traverse1.launches == before   # CPU: the plain version
    m, w, mrays, wrays = m.numpy(), w.numpy(), mrays.numpy(), wrays.numpy()
    assert m.shape == (height, width, 3) and mrays.dtype == np.int64

    js, jhost, jcam = scenes.load_pair(getattr(scenes, name)(), width,
                                       height, leaf_size=4)
    oracle = render_oracle(jhost, jcam, **kw)
    check_oracle_match(m, oracle)
    check_oracle_match(w, oracle)
    assert rmse(m, w) < 1e-6
    assert (mrays == wrays).all(), (mrays, wrays)
    _, jrays = jmk(js, jcam, **kw)
    jrays = np.asarray(jrays).astype(np.int64)
    assert (np.abs(mrays - jrays) <= np.maximum(16, 0.005 * jrays)).all(), (
        mrays, jrays)
    assert mrays[0] == width * height * spp
    return m, mrays


def test_triangle_1spp():
    m, _ = render_all("triangle_scene_glb", 256, 256, 1, 5)
    assert m.max() > 0.3 and m.std() > 0.01


def test_cube_multibounce_4spp():
    _, rays = render_all("cube_scene_glb", 96, 96, 4, 8)
    assert rays[3] > 0


def test_textured():
    m, _ = render_all("textured_scene_glb", 64, 64, 4, 4)
    assert m[..., 0].max() > 0.5 and m[..., 2].max() > 0.5


def test_dielectric_russian_roulette():
    """BASELINE config 3 with RR: the gate holds, RR kills paths from
    bounce 3 on, and the estimator keeps its mean."""
    _, rays_rr = render_all("dielectric_scene_glb", 64, 64, 16, 12, rr=True)
    scene, _, cam = tfix.load_pair(tfix.dielectric_scene_glb(), 64, 64,
                                   device="cpu")
    kw = dict(width=64, height=64, spp=16, max_depth=12, seed=0)
    plain, rays = mk.render_megakernel(scene, cam, **kw)
    rr, _ = mk.render_megakernel(scene, cam, rr=True, **kw)
    rays = rays.numpy()
    assert (rays_rr[:4] == rays[:4]).all() and rays_rr.sum() < rays.sum()
    assert abs(float(rr.mean()) - float(plain.mean())) < 0.02


def test_max_depth_zero_is_black_with_no_rays():
    scene, _, cam = tfix.load_pair(tfix.cube_scene_glb(), 16, 8,
                                   device="cpu")
    img, rays = mk.render_megakernel(scene, cam, width=16, height=8, spp=2,
                                     max_depth=0)
    assert tuple(img.shape) == (8, 16, 3) and (img == 0).all()
    assert tuple(rays.shape) == (0,) and int(rays.sum()) == 0


def test_image_does_not_depend_on_wave_size(monkeypatch):
    """Per-lane keys come from (seed, absolute sample, pixel), so cutting
    the samples into waves renders the same paths: equal tallies, and
    images equal up to the order of the float sums."""
    scene, _, cam = tfix.load_pair(tfix.cube_scene_glb(), 64, 64,
                                   device="cpu")
    kw = dict(width=64, height=64, spp=6, max_depth=6, seed=2)
    one, rays_one = mk.render_megakernel(scene, cam, **kw)
    offsets = []
    real = mk._wave

    def spy(scene_, cam_, seed, s, rays, **k):
        offsets.append((s, k["waves"]))
        return real(scene_, cam_, seed, s, rays, **k)

    monkeypatch.setattr(mk, "_wave", spy)
    monkeypatch.setattr(mk, "WAVE_RAYS", 4 * 64 * 64)
    many, rays_many = mk.render_megakernel(scene, cam, **kw)
    assert offsets == [(0, 4), (4, 2)]
    assert (rays_one == rays_many).all()
    np.testing.assert_allclose(one.numpy(), many.numpy(), rtol=0, atol=1e-6)


def test_renderer_registry():
    assert get_renderer("megakernel") is mk.render_megakernel
    assert get_renderer("wavefront") is render_wavefront
    with pytest.raises(KeyError, match="choices"):
        get_renderer("bidirectional")


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=_ROOT)
    return subprocess.run(
        [sys.executable, "-m", "sycl_ray_tracer_torch", "triangle",
         "--device", "cpu", "-s", "2", "-d", "3", "--width", "32",
         "--height", "24", *args], cwd=_ROOT, env=env, capture_output=True,
        text=True, timeout=120)


@pytest.mark.parametrize("flag", ["-m", "-w"])
def test_cli_engines_keep_the_stdout_contract(tmp_path, flag):
    """-m renders with the megakernel, -w (the default) with the
    wavefront; the three scraped lines are the same, and both engines
    count the same rays."""
    out = tmp_path / "img.png"
    p = _cli(flag, "-o", str(out))
    assert p.returncode == 0, p.stderr
    lines = p.stdout.splitlines()
    i = next(k for k, ln in enumerate(lines)
             if ln.startswith("Time measured"))
    assert re.fullmatch(r"Time measured: \d+\.\d{6} seconds", lines[i])
    m = re.fullmatch(r"Total rays: (\d+)", lines[i + 1])
    assert re.fullmatch(r"Rays/sec: \d+\.\d\dM", lines[i + 2])
    assert out.stat().st_size > 0
    scene, _, cam = tfix.load_pair(tfix.triangle_scene_glb(), 32, 24,
                                   leaf_size=8, device="cpu")
    _, rays = render_wavefront(scene, cam, width=32, height=24, spp=2,
                               max_depth=3)
    assert int(m.group(1)) == int(rays.sum())


@pytest.mark.parametrize("flags,engine", [
    ([], "wavefront"), (["-w"], "wavefront"), (["-m"], "megakernel"),
    (["-m", "-w"], "megakernel")])
def test_cli_picks_the_engine(monkeypatch, tmp_path, flags, engine):
    """With both flags the megakernel wins (main.cpp:58 checks -m
    first)."""
    from sycl_ray_tracer_torch.models import renderer
    from sycl_ray_tracer_torch.utils import cli

    picked, real = [], renderer.get_renderer

    def spy(name):
        picked.append(name)
        return real(name)

    monkeypatch.setattr(renderer, "get_renderer", spy)
    assert cli.main(["triangle", "--device", "cpu", "-s", "1", "-d", "1",
                     "--width", "8", "--height", "8", "-o",
                     str(tmp_path / "a.png"), *flags]) == 0
    assert picked == [engine]
