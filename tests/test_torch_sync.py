"""The host's waits for the device in a frame (utils/profile.py:sync) on
the CPU: each engine's srt.sync.<wait> ranges in a profiler trace, each
nested in its stage, their count per wave and per bounce, the count on
the SRT_PROFILE lines, frames bit-equal with the profiler and
SRT_PROFILE on and off, and the ranks' srt.ranks.reduce and
srt.sync.tallies ranges in a two-rank gloo render_sharded.

Waits per frame: each wave 3 (the camera's key seed and two jitter
counters, ops/rng.py:_u32), then each bounce 4 in the megakernel (its
live count and the scatter's three draw counters) and 6 in the
wavefront (its key seed and the scatter's three counters, the
terminated rays' index list, the live count); a sharded frame adds 2
(the tallies to the device and back). These are the CPU's counts: on the
card the scatter kernel takes its counters as arguments, which leaves 1
and 2 a bounce (tests/test_torch_cuda.py)."""

import collections
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile as tprofile

from sycl_ray_tracer_torch.models.megakernel import render_megakernel
from sycl_ray_tracer_torch.models.wavefront import render_wavefront
from sycl_ray_tracer_torch.parallel import mesh as pm
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils import profile
from sycl_ray_tracer_torch.utils.cli import timed_frame

from tests.torch_common import port_pair

# every bounce of this frame has live rays: tallies [1536, 802, 151, 67]
_KW = dict(width=32, height=24, spp=2, max_depth=4, seed=3)
PER_WAVE = 3
# engine: (render, waits per bounce, the stage that opens each bounce,
#          {wait: the stages it may lie in})
_ENGINES = {
    "wavefront": (render_wavefront, 6, "srt.intersect",
                  {"scalar": {"srt.generate", "srt.scatter"},
                   "terminated": {"srt.accumulate"},
                   "live": {"srt.compact"}}),
    "megakernel": (render_megakernel, 4, "srt.count",
                   {"scalar": {"srt.generate", "srt.scatter"},
                    "live": {"srt.count"}}),
}


def _host_ranges(prof):
    """[(start_ns, end_ns, name)] of the srt.* host ranges, by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("srt."))


@pytest.fixture(scope="module")
def cube():
    _, scene, cam = port_pair(tfix.cube_scene_glb(), 32, 24)
    return scene, cam


@pytest.mark.parametrize("engine", list(_ENGINES))
def test_sync_ranges_nest_in_their_stages(engine, cube):
    render, _, _, where = _ENGINES[engine]
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        render(*cube, **_KW)
    ranges = _host_ranges(prof)
    syncs = [r for r in ranges if r[2].startswith("srt.sync.")]
    stages = [r for r in ranges if not r[2].startswith("srt.sync.")]
    assert {n for _, _, n in syncs} == {f"srt.sync.{w}" for w in where}
    for s, e, name in syncs:
        inner = max(r for r in stages if r[0] <= s and e <= r[1])
        assert inner[2] in where[name[len("srt.sync."):]], (name, inner)


@pytest.mark.parametrize("engine", list(_ENGINES))
def test_sync_count_per_bounce(engine, cube, monkeypatch, capsys):
    """The trace's waits: PER_WAVE before the first bounce, then the
    same count in every bounce; the SRT_PROFILE lines carry the same
    counts as "syncs N"."""
    render, per_bounce, opens, _ = _ENGINES[engine]
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        _, rays = render(*cube, **_KW)
    ranges = _host_ranges(prof)
    bounces = [s for s, _, n in ranges if n == opens]
    assert len(bounces) == int((rays > 0).sum()) == _KW["max_depth"]
    starts = [s for s, _, n in ranges if n.startswith("srt.sync.")]
    cuts = bounces + [float("inf")]
    assert sum(s < cuts[0] for s in starts) == PER_WAVE
    assert [sum(a <= s < b for s in starts) for a, b in
            zip(cuts, cuts[1:])] == [per_bounce] * len(bounces)

    monkeypatch.setenv("SRT_PROFILE", "1")
    profs = []
    timed_frame(lambda: render(*cube, **_KW), torch.device("cpu"), profs)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[profile]") and " bounce " in ln]
    want = [PER_WAVE + per_bounce] + [per_bounce] * (len(bounces) - 1)
    assert [int(ln.split(", syncs ")[1].split(";")[0])
            for ln in lines] == want
    (p,) = profs
    assert [row[4] for row in p["rows"] if " bounce " in row[0]] == want
    assert p["syncs"] == len(starts) == sum(want)


@pytest.mark.parametrize("engine", list(_ENGINES))
def test_sync_ranges_change_nothing(engine, cube, monkeypatch):
    """The frame is bit-equal with the profiler on and off, and with
    SRT_PROFILE=1."""
    render = _ENGINES[engine][0]
    img, rays = render(*cube, **_KW)
    with tprofile(activities=[ProfilerActivity.CPU]):
        timg, trays = render(*cube, **_KW)
    monkeypatch.setenv("SRT_PROFILE", "1")
    (pimg, prays), _ = timed_frame(lambda: render(*cube, **_KW),
                                   torch.device("cpu"))
    for a, b in ((img, timg), (img, pimg)):
        assert torch.equal(a, b)
    assert torch.equal(rays, trays) and torch.equal(rays, prays)
    assert not profile._unread


def sharded_rank(rank, device, out_dir):
    """A rank's body (parallel/mesh.py:spawn's fn): one dp-2 wavefront
    frame under the profiler, then one with SRT_PROFILE=1; writes the
    counts of its srt.* ranges and its profile's rows."""
    _, scene, cam = port_pair(tfix.cube_scene_glb(), 32, 24)
    mesh = pm.make_mesh(2, 1)
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        _, rays = pm.render_sharded(scene, cam, mesh=mesh, **_KW)
    ranges = _host_ranges(prof)
    reduce = [r for r in ranges if r[2] == "srt.ranks.reduce"]
    os.environ["SRT_PROFILE"] = "1"
    pm.render_sharded(scene, cam, mesh=mesh, **_KW)
    (res,) = profile.report()
    out = {"names": collections.Counter(n for _, _, n in ranges),
           "reduce_holds_no_wait": all(
               not (a <= s < b) for a, b, _ in reduce
               for s, _, n in ranges if n.startswith("srt.sync.")),
           "rays": rays.tolist(),
           "rows": [[row[0], row[4]] for row in res["rows"]],
           "syncs": res["syncs"]}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def test_sharded_frame_shows_reduce_and_tallies(tmp_path):
    pm.spawn(sharded_rank, 2, "gloo", ["cpu"] * 2,
             f"file://{tmp_path / 'store'}", args=(str(tmp_path),))
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            r = json.load(f)
        names = r["names"]
        bounces = sum(" bounce " in label for label, _ in r["rows"])
        assert bounces == sum(n > 0 for n in r["rays"])
        assert names["srt.ranks.reduce"] == 1
        assert names["srt.sync.tallies"] == 2
        assert r["reduce_holds_no_wait"]
        # one wave of one sample a rank, then the tallies' two waits
        assert r["rows"][-1] == ["tail", 2]
        assert r["syncs"] == PER_WAVE + 6 * bounces + 2
        assert sum(v for n, v in names.items()
                   if n.startswith("srt.sync.")) == r["syncs"]
