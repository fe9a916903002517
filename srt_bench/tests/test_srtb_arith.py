"""The metric arithmetic on synthetic event lists."""

import importlib

import pytest

from srt_bench import arith, cells


def _window(**kw):
    base = dict(frames=2, window_s=0.0001, rays=1000, t0_us=0.0,
                t1_us=100.0, card="NVIDIA H100 80GB HBM3")
    base.update(kw)
    return arith.Window(**base)


def test_union_counts_overlap_once():
    assert arith.union_length([(0, 10), (5, 15), (20, 30)]) == 25
    assert arith.union_length([(0, 10), (2, 3)]) == 10
    assert arith.union_length([]) == 0


def test_idle_share_uses_the_union_clipped_to_the_window():
    w = _window(device_ops=[("k1", -10.0, 20.0), ("k2", 10.0, 30.0),
                            ("k3", 90.0, 120.0)])
    # busy: [0, 30] and [90, 100] -> 40 of 100
    assert arith.busy_us(w) == pytest.approx(40.0)
    assert cells.reader("idle_pct")(w) == pytest.approx(60.0)
    assert arith.gaps([(s, e) for _, s, e in w.device_ops], 0, 100) == \
        [(30.0, 90.0)]


def test_idle_reads_nothing_without_device_ops():
    assert cells.reader("idle_pct")(_window()) is None


def test_stage_ranges_sum_per_frame():
    w = _window(ranges=[("srt.compact", 0.0, 10.0), ("srt.compact", 50.0,
                                                     54.0),
                        ("srt.shade", 10.0, 20.0)])
    assert cells.reader("compact_ms")(w) == pytest.approx(14.0 / 1e3 / 2)
    assert cells.reader("shade_ms")(w) == pytest.approx(10.0 / 1e3 / 2)
    assert cells.reader("scatter_ms")(w) is None


def test_kernel_time_by_name_prefix():
    w = _window(device_ops=[("(anonymous namespace)::compact_lanes_kernel("
                             "unsigned char const*, long)", -5.0, 0.0),
                            ("(anonymous namespace)::traverse8_kernel(float "
                             "const*, int const*)", 0.0, 30.0),
                            ("void traverse5_kernel<true>(float const*)",
                             40.0, 50.0),
                            ("void at::native::elementwise_kernel<128, 4, "
                             "at::native::traverse_like>(int)", 0.0, 100.0),
                            ("ncclDevKernel_AllReduce_Sum_f32_RING_LL("
                             "ncclDevKernelArgsStorage<4096ul>)", 60.0, 70.0),
                            ("ncclDevKernel_Broadcast_RING_LL", 70.0, 80.0),
                            ("(anonymous namespace)::compact_lanes_kernel("
                             "unsigned char const*, long)", 80.0, 84.0)])
    # the compaction that traverse8's entry launches counts as intersect
    # work (the one before the window's start is clipped away)
    assert cells.reader("intersect_ms")(w) == pytest.approx(44.0 / 1e3 / 2)
    assert cells.reader("allreduce_ms")(w) == pytest.approx(10.0 / 1e3 / 2)


def test_roofline_counts_44_bytes_per_ray_at_the_published_bandwidth():
    assert arith.BYTES_PER_RAY == 44
    rays = 1_000_000_000
    w = _window(rays=rays, device_ops=[("traverse8_kernel", 0.0, 100.0)],
                frames=1, t1_us=1e9)
    least = rays * 44 / 3.35e12
    got = cells.reader("intersect_roofline")(w)
    assert got == pytest.approx(100.0 * least / 100e-6)
    assert arith.least_intersect_s(rays, "a card not in the table") is None
    assert cells.reader("intersect_roofline")(
        _window(card="cpu", device_ops=[("traverse8_kernel", 0, 1)])) is None


def test_breakdown_lists_ops_and_gaps():
    w = _window(device_ops=[("a", 0.0, 10.0), ("b", 10.0, 40.0),
                            ("a", 60.0, 70.0)],
                host_ranges=[("srtb.frame", 0.0, 100.0),
                             ("srt.compact", 40.0, 45.0)])
    assert arith.top_ops(w) == [["b", pytest.approx(30e-6)],
                                ["a", pytest.approx(20e-6)]]
    gaps = arith.top_gaps(w)
    assert gaps[0] == ["srtb.frame", pytest.approx(30e-6)]
    assert gaps[1] == ["srt.compact", pytest.approx(20e-6)]


def test_every_reader_is_found_by_name():
    import json
    import os

    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        assert callable(cells.reader(m["name"]))
    assert importlib.import_module("srt_bench.arith")
