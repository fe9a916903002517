"""The order in which traverse8's masked entry walks the live lanes
(csrc/order.cuh), on the CPU: the plain order (ops/traverse8.py
order_buckets, order_plain) against the wavefront's sort key
(models/wavefront.py _coherence_key), whose top ORDER_BITS bits are a
lane's bucket, and the host build of the card's ordering (csrc/
order_host.cpp, g++, a stable counting sort over the same bins, which
gathers each live lane's ray and lane into a record) against the plain
order, on crafted lanes (inactive lanes, -0.0 and non-finite
direction components, ties of the dominant axis, origins on the box's
corners and outside it), random lanes at counts around a block of 256
threads under all-dead, all-live and ragged masks, and the first bounce
of a small frame of the sponza-like fixture."""

from types import SimpleNamespace

import pytest
import torch

from sycl_ray_tracer_torch.models import trace as ttrace
from sycl_ray_tracer_torch.models import wavefront as twf
from sycl_ray_tracer_torch.ops import traverse8 as t8
from sycl_ray_tracer_torch.ops.kernels import ORDER_BITS
from sycl_ray_tracer_torch.ops.vec import V3
from sycl_ray_tracer_torch.utils.procgen import sponza_like_glb

from tests.torch_common import port_pair

torch.set_num_threads(2)

# the box [-2, 3] x [0, 1] x [5, 5 + 2**-10]; each row (origin,
# direction, active)
_LO, _HI = (-2.0, 0.0, 5.0), (3.0, 1.0, 5.0 + 2.0 ** -10)
_INF, _NAN = float("inf"), float("nan")
_CRAFTED = {
    "corner": [(_HI, (1.0, 1.0, 1.0), True),
               (_LO, (-1.0, -1.0, -1.0), True),
               (_HI, (-0.5, 0.25, -0.125), True),
               ((3.0, 1.0, 5.0), (0.0, 0.0, 1.0), True),
               ((2.9999998, 0.99999994, 5.0009761), (1.0, 0.0, 0.0), True),
               (_LO, (0.0, 1.0, 0.0), True)],
    "negzero": [((0.5, 0.5, 5.0), (-0.0, -0.0, -0.0), True),
                ((0.5, 0.5, 5.0), (-0.0, 0.0, -1.0), True),
                ((0.5, 0.5, 5.0), (1.0, -0.0, -0.0), True),
                ((-0.0, -0.0, 5.0), (-0.0, 1.0, -0.0), True)],
    "ties": [((0.1, 0.2, 5.0), (1.0, -1.0, 0.5), True),
             ((0.1, 0.2, 5.0), (-1.0, 0.5, 1.0), True),
             ((0.1, 0.2, 5.0), (0.5, 1.0, -1.0), True),
             ((0.1, 0.2, 5.0), (-1.0, -1.0, -1.0), True),
             ((0.1, 0.2, 5.0), (0.3, -0.3, 0.1), True)],
    "inactive": [((0.5, 0.5, 5.0), (1.0, 0.0, 0.0), False),
                 ((_NAN, 0.5, 5.0), (_NAN, 0.0, 0.0), False),
                 ((0.5, 0.5, 5.0), (-1.0, -1.0, -1.0), False),
                 ((0.5, 0.5, 5.0), (0.0, 1.0, 0.0), True),
                 (_HI, (-1.0, -1.0, -1.0), False)],
    "outside": [((-7.0, 0.5, 5.0), (1.0, 2.0, 3.0), True),
                ((1e30, -1e30, 1e30), (1.0, 2.0, 3.0), True),
                ((_INF, -_INF, 5.0), (3.0, 2.0, 1.0), True),
                ((0.5, 0.5, 5.0), (_INF, -_INF, 1.0), True),
                ((0.5, 0.5, 5.0), (_NAN, _NAN, _NAN), True)],
}


def _box():
    return torch.tensor(_LO), torch.tensor(_HI)


def _key_buckets(o, d, lo, hi):
    """The top ORDER_BITS bits of the wavefront's sort key of each ray."""
    key = twf._coherence_key(SimpleNamespace(scene_lo=lo, scene_hi=hi), o, d)
    return key >> (32 - ORDER_BITS)


def _hold(o, d, active, lo, hi):
    """The plain buckets against the sort key's top bits, and the host
    build's order against the plain order: the same lanes in the same
    order (both keep lane order within a bucket), each record's ray bit
    for bit, the live count, the inactive lanes' results (0, -1, 0, 0).
    Returns the plain order."""
    assert torch.equal(t8.order_buckets(o, d, lo, hi),
                       _key_buckets(o, d, lo, hi))
    want = t8.order_plain(o, d, active, lo, hi)
    rec, live, hit = t8.order(o, d, active, lo, hi)
    m = int(live)
    assert m == int(active.sum()) == want.numel()
    assert torch.equal(t8.record_lanes(rec, m), want)
    rays = torch.stack([c[want] for c in (*o, *d)], 1)
    assert torch.equal(rec[:m, :6].view(torch.int32), rays.view(torch.int32))
    assert bool((rec[:m, 7] == 0).all())
    ina = ~active
    assert bool((hit.t[ina] == 0).all()) and bool((hit.tri[ina] == -1).all())
    assert bool((hit.u[ina] == 0).all()) and bool((hit.v[ina] == 0).all())
    buckets = t8.order_buckets(o, d, lo, hi)[want]
    assert bool((buckets[1:] >= buckets[:-1]).all())
    return want


@pytest.mark.parametrize("case", list(_CRAFTED))
def test_order_of_crafted_lanes(case):
    rows = _CRAFTED[case]
    o = V3(*torch.tensor([r[0] for r in rows]).t().contiguous())
    d = V3(*torch.tensor([r[1] for r in rows]).t().contiguous())
    active = torch.tensor([r[2] for r in rows])
    lo, hi = _box()
    want = _hold(o, d, active, lo, hi)
    b = t8.order_buckets(o, d, lo, hi)
    cell = ORDER_BITS - 7
    assert bool(((b >> cell) & 3 == 0).all())   # the key's bits 25-26
    if case == "ties":   # dom: x wins no tie, y wins over z only
        assert ((b >> (ORDER_BITS - 5)) & 3).tolist() == [1, 2, 2, 2, 1]
    if case == "negzero":   # -0.0 is not below 0
        assert (b >> (ORDER_BITS - 3)).tolist() == [0, 1, 0, 0]
    if case == "corner":   # the top corner in the last cell, the low one
        top = (1 << cell) - 1    # in the first
        assert [int(b[i]) & top for i in (0, 1, 2, 5)] == [top, 0, top, 0]
    if case == "inactive":
        assert want.tolist() == [3]


def _random_lanes(r, seed):
    gen = torch.Generator().manual_seed(seed)
    o = V3(*(torch.rand(3, r, generator=gen) * 7.0 - torch.tensor(
        [[3.0], [1.0], [-4.0]])).contiguous())
    d = V3(*torch.randn(3, r, generator=gen).contiguous())
    return o, d, gen


@pytest.mark.parametrize("r", [0, 1, 255, 256, 257, 4097])
@pytest.mark.parametrize("mask", ["dead", "live", "ragged"])
def test_host_order_matches_plain_at_lane_counts(r, mask):
    o, d, gen = _random_lanes(r, r + 5)
    active = {"dead": torch.zeros(r, dtype=torch.bool),
              "live": torch.ones(r, dtype=torch.bool),
              "ragged": torch.rand(r, generator=gen) < 0.37}[mask]
    lo, hi = torch.tensor([-3.0, -1.0, 4.0]), torch.tensor([4.0, 6.0, 11.0])
    _hold(o, d, active, lo, hi)


def test_order_of_a_first_bounce():
    """The first bounce of a 40x30, 2-spp frame of the sponza-like
    fixture, in lane order as the megakernel holds it: the host order is
    the plain one, and a warp of the order meets far fewer direction
    classes (octant and dominant axis) than a warp of lane order."""
    _, scene, cam = port_pair(sponza_like_glb(scale=1), 40, 30)
    q, q_id = twf._gen_queue(cam, 5, 0,
                             pixels=twf.frame_pixels(40, 30, "cpu"), waves=2)
    hit = ttrace.intersect_scene(scene, V3(q[0], q[1], q[2]),
                                 V3(q[3], q[4], q[5]))
    q2, q_id2 = twf._bounce(scene, q, q_id, 0, torch.zeros((1200, 3)), 5, 0,
                            torch.arange(1200))
    del hit
    r = q.shape[1]
    rows = torch.zeros((6, r))
    rows[:, q_id2] = q2[0:6]
    active = torch.zeros(r, dtype=torch.bool)
    active[q_id2] = True
    o, d = V3(*rows[0:3]), V3(*rows[3:6])
    want = _hold(o, d, active, scene.scene_lo, scene.scene_hi)
    b = t8.order_buckets(o, d, scene.scene_lo, scene.scene_hi)
    live = active.nonzero().squeeze(1)

    cls = b >> (ORDER_BITS - 5)

    def per_warp(lanes):
        return sum(len(set(cls[lanes[i:i + 32]].tolist()))
                   for i in range(0, lanes.numel(), 32))

    assert 0 < live.numel() < r
    assert per_warp(want) * 4 < per_warp(live)


def test_order_refuses_bad_inputs():
    o, d, _ = _random_lanes(8, 1)
    lo, hi = _box()
    active = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        t8.traverse8(None, None, None, 0, o, d, order_box=(lo, hi))
    with pytest.raises(ValueError):
        t8.order(o, d, None, lo, hi)
    for bad in ((lo.double(), hi), (lo, hi[:2]), (lo, hi.to(torch.int32))):
        with pytest.raises(ValueError):
            t8.order(o, d, active, *bad)
    with pytest.raises(ValueError):
        t8.order(o, d, active.to(torch.uint8), lo, hi)
