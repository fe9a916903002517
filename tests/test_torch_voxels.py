"""The voxel world of the benchmark's minecraft_vox configuration
(srt_bench/scenes/voxels.py) through the port's two-level path on the
CPU, at a small size: both engines against the benchmark's plain
reference, and where the two-level path's work and waits fall in a
frame's trace (the stage ranges of utils/profile.py, and the count of
waits per frame that PERF.md section 3 gives for the CPU)."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile as tprofile
from torch.profiler import record_function

from srt_bench import cells, check, run
from srt_bench.reference import ingest
from srt_bench.reference.render import DeviceRef, camera, render_pixels
from srt_bench.scenes import voxels
from sycl_ray_tracer_torch.models import trace as ttrace
from sycl_ray_tracer_torch.models.camera import make_camera
from sycl_ray_tracer_torch.models.renderer import get_renderer
from sycl_ray_tracer_torch.utils.cli import load_scene

torch.set_num_threads(2)

# a 32 x 32 world seen from 4 m over its top, pitched down 0.6 rad: every
# material (grass, dirt, stone, iron, glowstone, water) meets the
# primary rays
_ARGS = dict(n=32, seed=3, water_level=5, pitch=0.6, height=4.0)
_W, _H, _SPP, _DEPTH = 40, 30, 8, 6
_SEED = 3_000_000_019 * 1000 + 7
_GLB = {}


def _glb():
    if not _GLB:
        _GLB["glb"] = voxels.voxel_world_glb(**_ARGS)
    return _GLB["glb"]


@pytest.mark.parametrize("engine", ["wavefront", "megakernel"])
def test_voxel_world_matches_the_reference(engine):
    """The port's two-level frame and the reference's over every pixel,
    within test_srtb_reference's tolerances: only paths that flip at a
    tie may differ."""
    glb = _glb()
    scene, host = load_scene(glb, "cpu", True, log=lambda *a: None)
    assert scene.has_instances
    cam = make_camera(_W, _H, host.camera_position, host.camera_direction,
                      host.camera_focal_length, device="cpu")
    img, rays = get_renderer(engine)(scene, cam, width=_W, height=_H,
                                     spp=_SPP, max_depth=_DEPTH, seed=_SEED)
    rs = ingest.load(glb)
    lane = torch.arange(_W * _H)
    ref, tallies = render_pixels(
        DeviceRef(rs, "cpu"), camera(rs, _W, _H, "cpu"), lane % _W,
        lane // _W, width=_W, spp=_SPP, max_depth=_DEPTH, seed=_SEED)
    paths = _W * _H * _SPP
    c = check.compare(img.reshape(-1, 3).numpy(), ref.numpy(), rays.numpy(),
                      tallies.numpy(), paths, paths,
                      {"pixel_q90": 0.0, "tally_gap": 0.0})
    assert c["pixel_q90"]["value"] < 5e-3
    assert c["tally_gap"]["value"] < 5e-3
    assert int((rays > 0).sum()) == _DEPTH


# the stage that each wait may lie in, and the waits a bounce on the
# CPU (PERF.md section 3: 3 a wave, and 6 a wavefront bounce or 4 a
# megakernel bounce)
_WAITS = {"wavefront": ({"scalar": {"srt.generate", "srt.scatter"},
                         "terminated": {"srt.accumulate"},
                         "live": {"srt.compact"}}, 6),
          "megakernel": ({"scalar": {"srt.generate", "srt.scatter"},
                          "live": {"srt.count"}}, 4)}


def _within(inner, outer):
    return any(a <= inner[0] and inner[1] <= b for a, b in outer)


@pytest.mark.parametrize("engine", list(_WAITS))
def test_voxel_frame_stages_and_waits(engine, monkeypatch):
    """In a traced two-level frame every traverse5 call lies in an
    srt.intersect range, the shade, scatter and the engine's compact or
    count stages are there, and each wait lies in its stage; a traced run
    of a tiny two-level cell (srt_bench.run on the CPU) reads
    syncs_per_frame as waves x (3 + bounces x B) and is correct."""
    allowed, per_bounce = _WAITS[engine]
    scene, host = load_scene(_glb(), "cpu", True, log=lambda *a: None)
    cam = make_camera(16, 12, host.camera_position, host.camera_direction,
                      host.camera_focal_length, device="cpu")
    real = ttrace.traverse5

    def probed(*a, **kw):
        with record_function("probe.traverse5"):
            return real(*a, **kw)

    monkeypatch.setattr(ttrace, "traverse5", probed)
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        get_renderer(engine)(scene, cam, width=16, height=12, spp=2,
                             max_depth=3, seed=5)
    spans = {}
    for e in prof.profiler.kineto_results.events():
        spans.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    probes = spans["probe.traverse5"]
    assert len(probes) == 3
    assert all(_within(p, spans["srt.intersect"]) for p in probes)
    stages = {"srt.shade", "srt.scatter",
              "srt.compact" if engine == "wavefront" else "srt.count"}
    assert stages <= set(spans)
    for wait, where in allowed.items():
        inside = [r for s in where for r in spans.get(s, [])]
        assert all(_within(r, inside) for r in spans[f"srt.sync.{wait}"])

    monkeypatch.setattr(ttrace, "traverse5", real)
    traffic = {"engine": engine, "cards": 1, "width": 16, "height": 12,
               "spp": 2, "max_depth": 3, "name": "tiny"}
    cell = cells.Cell(
        name=f"minecraft_vox.tiny_{engine}", chips=1,
        config={"generator": {"module": "srt_bench.scenes.voxels",
                              "function": "voxel_world_glb", "args": _ARGS},
                "form": "two_level", "name": "minecraft_vox"},
        traffic=traffic,
        check={"grid": [16, 12], "limits": {"pixel_q90": 0.02,
                                            "tally_gap": 0.015}},
        end_to_end=[],
        per_layer=[{"name": "syncs_per_frame", "unit": "count"}])
    tallies = []

    def wrap(render):
        def counted(*a, **kw):
            img, rays = render(*a, **kw)
            tallies.append(rays)
            return img, rays
        return counted

    r = run.run_rank(0, "cpu", cell, 7, 0.05, True, time.time(),
                     render_wrap=wrap)
    assert r["correct"], r["checks"]
    bounces = {int((rays > 0).sum()) for rays in tallies}
    assert bounces == {traffic["max_depth"]}
    assert r["metrics"]["syncs_per_frame"]["value"] == \
        3 + per_bounce * traffic["max_depth"]
    assert np.isfinite(r["checks"]["pixel_q90"]["value"])
