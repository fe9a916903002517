"""The readers of the host's waits, syncs_per_frame and sync_idle_ms, on
synthetic windows, and syncs_per_frame from a traced CPU run of a tiny
cell against the count the engines' code implies."""

import json
import os
import time

import pytest

from srt_bench import arith, cells, run


def _window(**kw):
    base = dict(frames=2, window_s=0.0001, rays=1000, t0_us=0.0,
                t1_us=100.0, card="NVIDIA H100 80GB HBM3")
    base.update(kw)
    return arith.Window(**base)


def test_syncs_per_frame_counts_sync_ranges_starting_in_the_window():
    w = _window(host_ranges=[("srt.sync.scalar", 10.0, 11.0),
                             ("srt.sync.live", 99.0, 120.0),
                             ("srt.sync.live", -5.0, 1.0),
                             ("srt.sync.tallies", 100.0, 101.0),
                             ("srt.scatter", 5.0, 20.0),
                             ("srtb.frame", 0.0, 100.0)])
    assert cells.reader("syncs_per_frame")(w) == pytest.approx(1.0)
    assert cells.reader("syncs_per_frame")(_window(host_ranges=[
        ("srt.scatter", 5.0, 20.0)])) is None


def test_sync_idle_takes_only_gaps_that_start_in_a_sync_range():
    # gaps of [0, 100]: (10, 30), (50, 60) and (95, 100)
    ops = [("k", -5.0, 10.0), ("k", 30.0, 50.0), ("k", 60.0, 95.0)]
    w = _window(device_ops=ops, host_ranges=[
        ("srt.scatter", 0.0, 60.0),
        ("srt.sync.scalar", 8.0, 31.0),   # holds the start of (10, 30)
        ("srt.sync.live", 45.0, 49.5),    # ends before (50, 60) starts
        ("srt.sync.live", 96.0, 99.0)])   # starts after (95, 100) does
    assert cells.reader("sync_idle_ms")(w) == pytest.approx(20.0 / 1e3 / 2)
    # the last gap, once a wait holds its start
    w.host_ranges.append(("srt.sync.terminated", 94.0, 96.0))
    assert cells.reader("sync_idle_ms")(w) == pytest.approx(25.0 / 1e3 / 2)


def test_sync_idle_reads_nothing_without_device_ops_or_waits():
    read = cells.reader("sync_idle_ms")
    assert read(_window(host_ranges=[("srt.sync.live", 1.0, 2.0)])) is None
    assert read(_window(device_ops=[("k", 0.0, 10.0)], host_ranges=[
        ("srt.count", 1.0, 20.0)])) is None


# waits a wave, and a bounce by engine (sycl_ray_tracer_torch/utils/
# profile.py:sync; tests/test_torch_sync.py holds them per bounce)
PER_WAVE, PER_BOUNCE = 3, {"wavefront": 6, "megakernel": 4}


@pytest.mark.parametrize("engine", list(PER_BOUNCE))
def test_traced_run_counts_the_waits(small, engine):
    bench_path, data = small
    traffic = {"engine": engine, "cards": 1, "width": 24, "height": 16,
               "spp": 2, "max_depth": 3}
    with open(os.path.join(data, "traffic", f"tiny_{engine}.json"),
              "w") as f:
        json.dump(traffic, f)
    name = f"sponza_proc.tiny_{engine}"
    with open(os.path.join(data, "limits",
                           "sponza_proc.wavefront.json")) as f:
        limits = json.load(f)
    limits["grid"] = [24, 16]
    with open(os.path.join(data, "limits", name + ".json"), "w") as f:
        json.dump(limits, f)
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": name, "config": "sponza_proc",
                               "traffic": f"tiny_{engine}", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        if m["name"] in ("syncs_per_frame", "sync_idle_ms"):
            m["workloads"].append(name)
    with open(bench_path, "w") as f:
        json.dump(bench, f)

    tallies = []

    def wrap(render):
        def counted(*a, **kw):
            img, rays = render(*a, **kw)
            tallies.append(rays)
            return img, rays
        return counted

    r = run.run_rank(0, "cpu", cells.load(name, bench_path, data), 7,
                     0.1, True, time.time(), render_wrap=wrap)
    assert r["correct"], r["checks"]
    bounces = {int((rays > 0).sum()) for rays in tallies}
    assert bounces == {traffic["max_depth"]}
    assert r["metrics"]["syncs_per_frame"]["value"] == \
        PER_WAVE + PER_BOUNCE[engine] * traffic["max_depth"]
    assert "sync_idle_ms" not in r["metrics"]  # no device operations
