"""The host's waits for the device in a frame (utils/profile.py:sync) on
the CPU: each engine's srt.sync.<wait> ranges in a profiler trace, each
nested in its stage, their count per wave and per bounce, the counts
by wait of the CLI's traced_frame (SRT_TRACE_DIR), frames bit-equal
with the profiler on and off, and the ranks' srt.ranks.reduce and
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
from sycl_ray_tracer_torch.utils.cli import traced_frame

from tests.torch_common import port_pair

# every bounce of this frame has live rays: tallies [1536, 802, 151, 67]
_KW = dict(width=32, height=24, spp=2, max_depth=4, seed=3)
PER_WAVE = 3
# engine: (render, {wait: its count per bounce}, the stage that opens
#          each bounce, {wait: the stages it may lie in})
_ENGINES = {
    "wavefront": (render_wavefront,
                  {"scalar": 4, "terminated": 1, "live": 1}, "srt.intersect",
                  {"scalar": {"srt.generate", "srt.scatter"},
                   "terminated": {"srt.accumulate"},
                   "live": {"srt.compact"}}),
    "megakernel": (render_megakernel, {"scalar": 3, "live": 1}, "srt.count",
                   {"scalar": {"srt.generate", "srt.scatter"},
                    "live": {"srt.count"}}),
}


def _host_ranges(prof):
    """[(start_ns, end_ns, name)] of the srt.* host ranges, by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("srt."))


def _waits_between(ranges, cuts):
    """The count of srt.sync.* ranges that start before cuts[0], then
    between each cut and the next, then after the last cut."""
    starts = [s for s, _, n in ranges if n.startswith("srt.sync.")]
    edges = [float("-inf"), *cuts, float("inf")]
    return [sum(a <= s < b for s in starts) for a, b in
            zip(edges, edges[1:])]


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
def test_sync_count_per_bounce(engine, cube):
    """The trace's waits: PER_WAVE before the first bounce, then the
    same count in every bounce."""
    render, per_bounce, opens, _ = _ENGINES[engine]
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        _, rays = render(*cube, **_KW)
    ranges = _host_ranges(prof)
    bounces = [s for s, _, n in ranges if n == opens]
    assert len(bounces) == int((rays > 0).sum()) == _KW["max_depth"]
    assert _waits_between(ranges, bounces) == (
        [PER_WAVE] + [sum(per_bounce.values())] * len(bounces))


@pytest.mark.parametrize("engine", list(_ENGINES))
def test_traced_frame_counts_waits(engine, cube, tmp_path):
    """utils/cli.py:traced_frame (SRT_TRACE_DIR) writes its trace and
    counts each wait of the frame by name: PER_WAVE scalar waits, then
    each bounce's."""
    render, per_bounce, _, _ = _ENGINES[engine]
    (_, rays), _, stats = traced_frame(
        lambda: render(*cube, **_KW), torch.device("cpu"), str(tmp_path),
        log=lambda line: None)
    bounces = int((rays > 0).sum())
    want = {f"srt.sync.{w}": n * bounces for w, n in per_bounce.items()}
    want["srt.sync.scalar"] += PER_WAVE
    assert stats["syncs"] == want
    assert os.path.isfile(tmp_path / "trace_rank0.json")


@pytest.mark.parametrize("engine", list(_ENGINES))
def test_sync_ranges_change_nothing(engine, cube):
    """The frame is bit-equal with the profiler on and off."""
    render = _ENGINES[engine][0]
    img, rays = render(*cube, **_KW)
    with tprofile(activities=[ProfilerActivity.CPU]):
        timg, trays = render(*cube, **_KW)
    assert torch.equal(img, timg)
    assert torch.equal(rays, trays)


def sharded_rank(rank, device, out_dir):
    """A rank's body (parallel/mesh.py:spawn's fn): one dp-2 wavefront
    frame under the profiler; writes the counts of its srt.* ranges and
    of its waits before the first bounce, in each bounce (cut at each
    srt.intersect, the last bounce ending with its srt.compact) and
    after the last."""
    _, scene, cam = port_pair(tfix.cube_scene_glb(), 32, 24)
    mesh = pm.make_mesh(2, 1)
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        _, rays = pm.render_sharded(scene, cam, mesh=mesh, **_KW)
    ranges = _host_ranges(prof)
    reduce = [r for r in ranges if r[2] == "srt.ranks.reduce"]
    cuts = [s for s, _, n in ranges if n == "srt.intersect"]
    cuts.append(max(e for _, e, n in ranges if n == "srt.compact"))
    out = {"names": collections.Counter(n for _, _, n in ranges),
           "reduce_holds_no_wait": all(
               not (a <= s < b) for a, b, _ in reduce
               for s, _, n in ranges if n.startswith("srt.sync.")),
           "rays": rays.tolist(),
           "waits": _waits_between(ranges, cuts)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def test_sharded_frame_shows_reduce_and_tallies(tmp_path):
    pm.spawn(sharded_rank, 2, "gloo", ["cpu"] * 2,
             f"file://{tmp_path / 'store'}", args=(str(tmp_path),))
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            r = json.load(f)
        names = r["names"]
        bounces = names["srt.intersect"]
        assert bounces == sum(n > 0 for n in r["rays"])
        assert names["srt.ranks.reduce"] == 1
        assert names["srt.sync.tallies"] == 2
        assert r["reduce_holds_no_wait"]
        # one wave of one sample a rank, then the tallies' two waits
        assert r["waits"] == [PER_WAVE] + [6] * bounces + [2]
        assert sum(v for n, v in names.items()
                   if n.startswith("srt.sync.")) == sum(r["waits"])
