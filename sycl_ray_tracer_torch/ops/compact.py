"""The wavefront's queue compaction by hand: a key pass, a stable radix
sort and a gather, all launched on the card (csrc/compact.cu; the
per-lane code is csrc/compact.cuh). models/wavefront.py runs it on the
card in place of the eager _compact, _coherence_key, stack and gather,
and gets the same next queue bit for bit.

- keys(scene, q, q_id, hit_t, new_dir, new_att, rad_hit, terminated) ->
  (key [N] int32, rec [N, 16] f32, stats [1025] int64): for each live
  lane (not terminated) the dir6_morton key of its new origin o + d * t
  and new direction, clamped one below the dead sentinel, and its
  64-byte record (new origin, direction, attenuation, radiance: the next
  queue's 12 rows; then its queue id's bits in columns 12-13); a dead
  lane gets the sentinel and no record. The keys are unsigned 32-bit
  words in the int32 tensor. stats[0] counts the live lanes, stats[1 +
  256 p + d] the keys whose digit p (8 bits, lowest first) is d.
- sort(key, stats) -> perm [N] int32: the lanes in stable ascending
  order of their unsigned keys (4 passes of 8-bit digits). On the card
  it takes key's buffer as scratch.
- gather(rec, perm) -> (q2 [12, M] f32, q_id2 [M] int64): the rows and
  queue ids of the lanes perm [M] int32, in that order.

On CUDA tensors each wrapper checks its inputs, allocates its outputs
with torch.empty (counts and the sort's look-back words with
torch.zeros), launches on the current stream and raises if a launch
reports a CUDA error; keys.launches, sort.launches and gather.launches
count the calls (the sort is 4 launches a call). On CPU tensors it runs
the g++ build of the same per-lane code and a plain counting sort on the
same digits (csrc/compact_host.cpp), the tests' view of the kernels. The
engine calls these only on the card: on the CPU it runs the plain
compaction of models/wavefront.py, the reference.
"""

from __future__ import annotations

import ctypes

import torch

from sycl_ray_tracer_torch.ops import kernels
from sycl_ray_tracer_torch.ops.vec import V3

ROWS = 12
REC_FLOATS = 16
# stats: the live count, then 4 digits' counts of 256 each
STATS = 1 + 4 * 256

_P = ctypes.c_void_p


class _CompactIn(ctypes.Structure):
    _fields_ = [("q", _P), ("q_id", _P), ("hit_t", _P), ("rows", _P * 9),
                ("terminated", _P), ("scene_lo", _P), ("scene_hi", _P),
                ("n", ctypes.c_int64)]


class _CompactOut(ctypes.Structure):
    _fields_ = [("rec", _P), ("key", _P), ("stats", _P)]


class _SortBufs(ctypes.Structure):
    _fields_ = [("key", _P), ("key_alt", _P), ("val_a", _P), ("val_b", _P),
                ("stats", _P), ("scratch", _P), ("n", ctypes.c_int64)]


def keys(scene, q: torch.Tensor, q_id: torch.Tensor, hit_t: torch.Tensor,
         new_dir: V3, new_att: V3, rad_hit: V3, terminated: torch.Tensor):
    """The key pass over the N lanes of the queue q [12, N] (origin,
    direction, ...) and q_id [N] int64, their hits' t [N], the scatter
    stage's new direction, attenuation and radiance (V3s of [N] rows) and
    terminated flags [N]: (key, rec, stats) as the module says."""
    dev = kernels.entry_device(q)
    n = q.shape[1] if q.dim() == 2 else -1
    if n >= 2**30:
        raise ValueError("the compaction sorts at most 2**30 - 1 lanes")
    kernels.check("q", q, torch.float32, (12, n), dev)
    kernels.check("q_id", q_id, torch.int64, (n,), dev)
    kernels.check("hit_t", hit_t, torch.float32, (n,), dev)
    rows = [*new_dir, *new_att, *rad_hit]
    for c in rows:
        kernels.check("new_dir, new_att, rad_hit", c, torch.float32, (n,),
                      dev)
    kernels.check("terminated", terminated, torch.bool, (n,), dev)
    for name in ("scene_lo", "scene_hi"):
        kernels.check(name, getattr(scene, name), torch.float32, (3,), dev)
    key = torch.empty((n,), dtype=torch.int32, device=dev)
    rec = torch.empty((n, REC_FLOATS), dtype=torch.float32, device=dev)
    stats = torch.zeros((STATS,), dtype=torch.int64, device=dev)
    kin = _CompactIn(q.data_ptr(), q_id.data_ptr(), hit_t.data_ptr(),
                     (_P * 9)(*(c.data_ptr() for c in rows)),
                     terminated.data_ptr(), scene.scene_lo.data_ptr(),
                     scene.scene_hi.data_ptr(), n)
    kout = _CompactOut(rec.data_ptr(), key.data_ptr(), stats.data_ptr())
    kernels.call("compact_keys", dev, ctypes.byref(kin), ctypes.byref(kout))
    if dev.type == "cuda":
        keys.launches += 1
    return key, rec, stats


keys.launches = 0


def sort(key: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """perm [N] int32: the lanes in stable ascending order of key [N]
    (unsigned 32-bit words in int32, from keys, with its stats)."""
    dev = kernels.entry_device(key)
    n = key.shape[0] if key.dim() == 1 else -1
    kernels.check("key", key, torch.int32, (n,), dev)
    kernels.check("stats", stats, torch.int64, (STATS,), dev)
    key_alt, val_a, val_b = (torch.empty((n,), dtype=torch.int32,
                                         device=dev) for _ in range(3))
    scratch = None
    if dev.type == "cuda":
        scratch = torch.zeros(
            (kernels.load_library().srt_compact_sort_scratch(n),),
            dtype=torch.int32, device=dev)
    bufs = _SortBufs(key.data_ptr(), key_alt.data_ptr(), val_a.data_ptr(),
                     val_b.data_ptr(), stats.data_ptr(),
                     kernels._ptr(scratch), n)
    kernels.call("compact_sort", dev, ctypes.byref(bufs))
    if dev.type == "cuda":
        sort.launches += 1
    return val_b


sort.launches = 0


def gather(rec: torch.Tensor, perm: torch.Tensor):
    """The next queue (q2 [12, M], q_id2 [M]) of the live lanes perm [M]
    int32 (indices into rec [N, 16] from keys)."""
    dev = kernels.entry_device(rec)
    n = rec.shape[0]
    m = perm.shape[0] if perm.dim() == 1 else -1
    kernels.check("rec", rec, torch.float32, (n, REC_FLOATS), dev)
    kernels.check_aligned("rec", rec)
    kernels.check("perm", perm, torch.int32, (m,), dev)
    if m > n:
        raise ValueError(f"perm: {m} entries for {n} lanes")
    q2 = torch.empty((ROWS, m), dtype=torch.float32, device=dev)
    q_id2 = torch.empty((m,), dtype=torch.int64, device=dev)
    kernels.call("compact_gather", dev, rec.data_ptr(), perm.data_ptr(), m,
                 q2.data_ptr(), q_id2.data_ptr())
    if dev.type == "cuda":
        gather.launches += 1
    return q2, q_id2


gather.launches = 0
