"""The queue compaction's per-lane code (csrc/compact.cuh), built by g++
(csrc/compact_host.cpp), against the plain compaction of
models/wavefront.py on the CPU, bit for bit: the key pass's 32-bit keys
against _coherence_key (clamped below the dead sentinel, dead lanes the
sentinel), its records against the stacked rows, its live and digit
counts, the radix sort's order (the host build's counting passes on the
same digits) against a stable argsort, and the whole compaction by hand
against _compact_plain's next queue, on the bounces of small frames of
the sponza-like fixture and of the voxel world of
tests/test_torch_voxels.py, and on crafted lanes: origins on the
scene's corners and outside its box, -0.0 and non-finite direction
components, ties of the dominant axis, dead lanes, and the largest key.

No dir6_morton key meets the clamp below the sentinel: its bits 25-26
are always 0, so the largest live key is 0xF1FFFFFF (the "largest"
case), as in the plain path."""

from types import SimpleNamespace

import pytest
import torch

from srt_bench.scenes import voxels
from sycl_ray_tracer_torch.models import trace as ttrace
from sycl_ray_tracer_torch.models import wavefront as twf
from sycl_ray_tracer_torch.models.camera import make_camera
from sycl_ray_tracer_torch.ops import compact
from sycl_ray_tracer_torch.ops.vec import V3
from sycl_ray_tracer_torch.utils.cli import load_scene
from sycl_ray_tracer_torch.utils.procgen import sponza_like_glb

from tests.torch_common import port_pair

torch.set_num_threads(2)

W, H = 40, 30
SEED = 3_000_000_019 * 1000 + 7
_MASK = 0xFFFFFFFF
_VOXELS = dict(n=32, seed=3, water_level=5, pitch=0.6, height=4.0)
_CACHE = {}
_PLAIN = twf._compact_plain


def _scene(name):
    """(scene, camera) of a fixture on the CPU."""
    if name not in _CACHE:
        if name == "sponza":
            _, scene, cam = port_pair(sponza_like_glb(scale=1), W, H)
        else:
            scene, host = load_scene(voxels.voxel_world_glb(**_VOXELS),
                                     "cpu", True, log=lambda *a: None)
            cam = make_camera(W, H, host.camera_position,
                              host.camera_direction,
                              host.camera_focal_length, device="cpu")
        _CACHE[name] = scene, cam
    return _CACHE[name]


def _plain_key(scene, q, t, new_dir, terminated):
    """The sort key of the plain compaction as unsigned 32 bits in int64:
    _coherence_key of the new origin, clamped below the sentinel, and
    the sentinel on a dead lane."""
    o, d = V3(q[0], q[1], q[2]), V3(q[3], q[4], q[5])
    key = twf._coherence_key(scene, o + d * t, new_dir)
    return torch.where(~terminated, key.clamp(max=twf._DEAD_KEY - 1),
                       twf._DEAD_KEY)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN equal to NaN of the same bits)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


def _check_lanes(scene, q, q_id, t, new_dir, new_att, rad_hit,
                 terminated):
    """The host key pass and the compaction by hand against the plain
    compaction on one bounce's lanes; returns the live count."""
    key, rec, stats = compact.keys(scene, q, q_id, t, new_dir, new_att,
                                   rad_hit, terminated)
    alive = ~terminated
    live = stats[0]
    assert int(live) == int(alive.sum())
    want = _plain_key(scene, q, t, new_dir, terminated)
    assert torch.equal(key.to(torch.int64) & _MASK, want)
    for p in range(4):
        digits = (want >> (8 * p)) & 255
        assert torch.equal(stats[1 + 256 * p:257 + 256 * p],
                           torch.bincount(digits, minlength=256))
    perm = compact.sort(key, stats)
    assert torch.equal(perm.long(), torch.argsort(want, stable=True))
    o, d = V3(q[0], q[1], q[2]), V3(q[3], q[4], q[5])
    rows = torch.stack([*(o + d * t), *new_dir, *new_att, *rad_hit])
    assert _same(rec[alive, :12].t().contiguous(),
                 rows[:, alive].contiguous())
    assert torch.equal(rec.view(torch.int64)[alive, 6], q_id[alive])
    lanes = [t, new_dir, new_att, rad_hit, terminated]
    plain = _PLAIN(scene, q, q_id, lanes)
    mine = twf._compact_by_hand(scene, q, q_id, list(lanes))
    assert _same(mine[0], plain[0]) and torch.equal(mine[1], plain[1])
    return int(live)


@pytest.mark.parametrize("scene_name", ["sponza", "voxels"])
def test_host_compaction_matches_plain_on_frame_bounces(scene_name,
                                                        monkeypatch):
    """Every bounce of a 40x30, 2-spp, depth-6 frame: the host build's
    keys, records and live count, and the next queue of the compaction
    by hand, equal the plain compaction's; the frame is the plain one."""
    scene, cam = _scene(scene_name)
    lives = []

    def both(scene, q, q_id, lanes):
        lives.append(_check_lanes(scene, q, q_id, *lanes))
        return _PLAIN(scene, q, q_id, lanes)

    monkeypatch.setattr(twf, "_compact_plain", both)
    _, rays = twf.render_wavefront(scene, cam, width=W, height=H, spp=2,
                                   max_depth=6, seed=SEED)
    assert lives == rays.tolist()[1:] + [lives[-1]]
    assert len(lives) == 6 and 0 < lives[-1] < lives[0] < W * H * 2


def _first_bounce(scene_name):
    """The lanes of a frame's first bounce through the plain stages."""
    scene, cam = _scene(scene_name)
    q, q_id = twf._gen_queue(cam, SEED, 0,
                             pixels=twf.frame_pixels(W, H, "cpu"), waves=2)
    hit = ttrace.intersect_scene(scene, V3(q[0], q[1], q[2]),
                                 V3(q[3], q[4], q[5]))
    nd, na, rh, term = twf._stages_plain(
        scene, q, q_id, hit, hit.tri < 0, 0, torch.zeros((W * H, 3)), SEED,
        0, torch.arange(W * H), False)
    return scene, q, q_id, hit.t, nd, na, rh, term


# crafted lanes in the box [-2, 3] x [0, 1] x [5, 5 + 2**-10]: each row
# (origin, direction, t, terminated)
_LO, _HI = (-2.0, 0.0, 5.0), (3.0, 1.0, 5.0 + 2.0 ** -10)
_INF, _NAN = float("inf"), float("nan")
_CRAFTED = {
    "corner": [(_HI, (1.0, 1.0, 1.0), 0.0, False),
               (_LO, (-1.0, -1.0, -1.0), 0.0, False),
               (_HI, (-0.5, 0.25, -0.125), 0.0, False),
               ((3.0, 1.0, 5.0), (0.0, 0.0, 1.0), 0.0, False),
               ((2.9999998, 0.99999994, 5.0009761), (1.0, 0.0, 0.0), 0.0,
                False)],
    "negzero": [((0.5, 0.5, 5.0), (-0.0, -0.0, -0.0), 1.0, False),
                ((0.5, 0.5, 5.0), (-0.0, 0.0, -1.0), 0.25, False),
                ((0.5, 0.5, 5.0), (1.0, -0.0, -0.0), 0.5, False),
                ((-0.0, -0.0, 5.0), (-0.0, 1.0, -0.0), 0.0, False)],
    "ties": [((0.1, 0.2, 5.0), (1.0, -1.0, 0.5), 0.5, False),
             ((0.1, 0.2, 5.0), (-1.0, 0.5, 1.0), 0.5, False),
             ((0.1, 0.2, 5.0), (0.5, 1.0, -1.0), 0.5, False),
             ((0.1, 0.2, 5.0), (-1.0, -1.0, -1.0), 0.5, False),
             ((0.1, 0.2, 5.0), (0.3, -0.3, 0.1), 0.125, False)],
    "dead": [((0.5, 0.5, 5.0), (1.0, 0.0, 0.0), _INF, True),
             ((_NAN, 0.5, 5.0), (_NAN, 0.0, 0.0), _NAN, True),
             ((0.5, 0.5, 5.0), (-1.0, -1.0, -1.0), 1.0, True),
             ((0.5, 0.5, 5.0), (0.0, 1.0, 0.0), 0.0, False),
             (_HI, (-1.0, -1.0, -1.0), 0.0, True)],
    "largest": [(_HI, (-0.5, -0.5, -1.0), 0.0, False),
                (_HI, (-1.0, -1.0, -1.0), 0.0, False),
                ((9.0, 9.0, 9.0), (-0.25, -0.5, -0.75), 0.0, False)],
    "outside": [((-7.0, 0.5, 5.0), (1.0, 2.0, 3.0), 1.0, False),
                ((1e30, -1e30, 1e30), (1.0, 2.0, 3.0), 0.0, False),
                ((_INF, -_INF, 5.0), (3.0, 2.0, 1.0), 0.0, False),
                ((_NAN, 0.5, 5.0), (1.0, 0.0, 0.0), 0.0, False),
                ((0.5, 0.5, 5.0), (_NAN, _NAN, _NAN), 0.0, False),
                ((0.5, 0.5, 5.0), (_INF, -_INF, 1.0), 0.0, False)],
}


def _crafted(case):
    lanes = _CRAFTED[case]
    n = len(lanes)
    scene = SimpleNamespace(scene_lo=torch.tensor(_LO),
                            scene_hi=torch.tensor(_HI))
    q = torch.zeros((12, n))
    q[0:3] = torch.tensor([ln[0] for ln in lanes]).t()
    q[6:12] = torch.arange(6 * n, dtype=torch.float32).reshape(6, n) / 7
    t = torch.tensor([ln[2] for ln in lanes])
    new_dir = V3(*torch.tensor([ln[1] for ln in lanes]).t().contiguous())
    att = V3(*(q[6:9] * 0.5).contiguous())
    rad = V3(*(q[9:12] + 0.25).contiguous())
    term = torch.tensor([ln[3] for ln in lanes])
    q_id = torch.arange(n) * 5 + 3
    return scene, q, q_id, t, new_dir, att, rad, term


@pytest.mark.parametrize("case", ["first_bounce_sponza",
                                  "first_bounce_voxels", *_CRAFTED])
def test_host_keys_and_records_match_plain(case):
    """One set of lanes: host keys, records, live count and compaction
    equal the plain compaction's bit for bit."""
    if case.startswith("first_bounce"):
        lanes = _first_bounce(case.rsplit("_", 1)[1])
    else:
        lanes = _crafted(case)
    live = _check_lanes(*lanes)
    scene, q, _, t, new_dir, _, _, term = lanes
    key = _plain_key(scene, q, t, new_dir, term)
    assert live == int((~term).sum())
    if case == "dead":
        assert (key[term] == twf._DEAD_KEY).all() and live == 1
    if case == "largest":
        assert int(key.max()) == 0xF1FFFFFF
    if case == "ties":   # dom: x wins no tie, y wins over z only
        assert ((key >> 27) & 3).tolist() == [1, 2, 2, 2, 1]
    if case == "negzero":   # -0.0 is not below 0
        assert (key >> 29).tolist() == [0, 1, 0, 0]
    if case.startswith("first_bounce"):
        assert 0 < live < q.shape[1]
        assert len(set(key[~term].tolist())) > 50
