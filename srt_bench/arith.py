"""The yardstick's arithmetic: what the per-layer metrics compute from
a traced window, with no torch in it, so that it runs on synthetic
event lists in the tests.

A traced window is a Window: the device operations (kernels, copies,
sets) and the device-side `srt.<stage>` ranges of the profiler's trace,
each as (name, start_us, end_us), the bounds of the window in the same
clock, and the frames and rays rendered in it.
"""

from __future__ import annotations

import dataclasses
import json
import os

# A closest-hit query needs at the least its ray read once (origin,
# direction and t limit: 7 f32, 28 bytes) and its hit written once (t,
# triangle id, u, v: 16 bytes), whatever tree or kernel answers it.
RAY_BYTES = 28
HIT_BYTES = 16
BYTES_PER_RAY = RAY_BYTES + HIT_BYTES

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "peaks.json")


@dataclasses.dataclass
class Window:
    """What one traced run hands the metric readers (rank 0's view in a
    run over several cards)."""

    frames: int                 # frames completed in the window
    window_s: float             # the window's length, host clock
    rays: int                   # rays traced in it, from the tallies
    t0_us: float = 0.0          # window bounds in the trace's clock
    t1_us: float = 0.0
    device_ops: list = dataclasses.field(default_factory=list)
    ranges: list = dataclasses.field(default_factory=list)
    host_ranges: list = dataclasses.field(default_factory=list)
    build_s: float | None = None
    tables_bytes: int | None = None
    card: str = ""              # torch.cuda.get_device_name()


def clip(intervals, t0: float, t1: float):
    """The intervals (start, end) cut to [t0, t1]; empty ones dropped."""
    out = []
    for s, e in intervals:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            out.append((s, e))
    return out


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals: time in which at
    least one of them was running, overlap counted once."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, t0: float, t1: float):
    """The idle gaps (start, end) of [t0, t1] that no interval covers,
    longest first."""
    out, cur = [], t0
    for s, e in sorted(clip(intervals, t0, t1)):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return sorted(out, key=lambda g: g[0] - g[1])


def busy_us(w: Window) -> float:
    """Microseconds of the window in which some device operation ran."""
    return union_length(clip([(s, e) for _, s, e in w.device_ops],
                             w.t0_us, w.t1_us))


def range_ms_per_frame(w: Window, name: str) -> float | None:
    """Device milliseconds of the ranges called `name`, summed over the
    window, per frame; None when the trace holds no such range."""
    spans = [(s, e) for n, s, e in w.ranges if n == name]
    if not spans or not w.frames:
        return None
    return sum(e - s for s, e in clip(spans, w.t0_us, w.t1_us)) \
        / 1e3 / w.frames


def bare_name(name: str) -> str:
    """A device operation's function name alone: "void
    (anonymous namespace)::traverse8_kernel<4>(float const*, ...)" is
    "traverse8_kernel"."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def intersect_kernel(bare: str) -> bool:
    """The device operations of the port's intersect entries: the
    traversal kernels, and the compaction of live lanes that each
    entry launches before its kernel when given a mask of live lanes
    (as the megakernel gives it)."""
    return bare.startswith("traverse") or bare == "compact_lanes_kernel"


def ops_ms_per_frame(w: Window, match) -> float | None:
    """Device milliseconds of the operations whose bare_name satisfies
    match(name), per frame, their overlap counted once; None when none
    ran."""
    spans = [(s, e) for n, s, e in w.device_ops if match(bare_name(n))]
    if not spans or not w.frames:
        return None
    return union_length(clip(spans, w.t0_us, w.t1_us)) / 1e3 / w.frames


def peaks(card: str) -> dict | None:
    """The published peaks of a card by its torch name, or None."""
    with open(_PEAKS) as f:
        return json.load(f)["cards"].get(card)


def least_intersect_s(rays: int, card: str) -> float | None:
    """The least time in which `card` can answer `rays` closest-hit
    queries: their bytes (BYTES_PER_RAY each) over its memory
    bandwidth. None for a card the table does not hold."""
    p = peaks(card)
    if p is None:
        return None
    return rays * BYTES_PER_RAY / p["hbm_bytes_per_s"]


def top_ops(w: Window, n: int = 10):
    """[[name, seconds]] of the n device operations with the most device
    time in the window, summed by name (names cut to 160 characters)."""
    by = {}
    for name, s, e in w.device_ops:
        for cs, ce in clip([(s, e)], w.t0_us, w.t1_us):
            by[name] = by.get(name, 0.0) + (ce - cs) / 1e6
    return [[k[:160], v]
            for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def top_gaps(w: Window, n: int = 10):
    """[[label, seconds]] of the n longest idle gaps of the device in
    the window, each named by the innermost host range that covers the
    gap's start (the deepest `srt.<stage>` or `srtb.*` range), or
    "host" where none does."""
    ops = [(s, e) for _, s, e in w.device_ops]
    out = []
    for s, e in gaps(ops, w.t0_us, w.t1_us)[:n]:
        inner = [(hs, he, name) for name, hs, he in w.host_ranges
                 if hs <= s < he]
        label = max(inner)[2] if inner else "host"
        out.append([label, (e - s) / 1e6])
    return out
