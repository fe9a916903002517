"""Per-stage clock of the engines (SRT_PROFILE=1) and the stage ranges
of a profiler trace.

The reference keeps a per-phase wall clock dormant in its wavefront
engine (print_elapsed, render_wavefront.cpp:129-137); the JAX package
turns it on with SRT_PROFILE=1 (models/wavefront.py:573-575, 625-648).
Here each stage of a bounce runs inside `stage(prof, name)`:

- always, a torch.profiler.record_function range "srt.<name>", so a
  trace (utils/cli.py:traced_frame) shows the stages by name;
- with a FrameProfile (SRT_PROFILE=1), also a mark at each end of the
  stage: a CUDA event pair on the card, read only after the frame's
  closing synchronize, and the host's perf_counter. On the CPU the
  host's clock is the stage's time.

Stages: generate (camera rays, once per wave), intersect, shade
(shading gathers, emission and the sky term), scatter (the material's
scatter and russian roulette), accumulate (the terminated rays into the
pixels) and compact (the wavefront's sort key, argsort and gather; the
megakernel has no compaction and names its live-count read "count").

Each point where the host waits for the card inside a frame runs in
`sync(prof, name)`: a record_function range "srt.sync.<name>" around
the blocking call alone while a profiler runs, and with a FrameProfile
a count of the wait in the current row. The waits:

- scalar: a Python int copied to the device (ops/rng.py:_u32: the
  camera's seed and jitter counters; on the CPU also the wavefront's
  per-bounce key seed and the scatter's three draw counters, which the
  card's scatter kernel takes as launch arguments), a blocking upload
  from pageable memory;
- live: the live-count read, the megakernel's in its "count" stage and
  the wavefront's in "compact";
- terminated: the wavefront's index list of the terminated rays
  (nonzero) in "accumulate";
- tallies: parallel/mesh.py:render_sharded's copies of the tallies to
  and from the device.

Code that is not handed the frame's profile (ops/rng.py,
parallel/mesh.py) counts into current(), the newest profile not yet
reported.

With SRT_PROFILE unset, start() returns None and the engines create no
event and read nothing more from the device.

A frame's profile is printed by report(), which utils/cli.py:
timed_frame calls after its closing synchronize: one line per bounce
(its stage times and its count of waits, "syncs N"), then one line of
the frame's totals per stage and its waits. The engines keep the
reference's render signature, so a frame's profile waits in this
process's list until then.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import record_function

# the wavefront's stages, in the order a bounce runs them
STAGES = ("generate", "intersect", "shade", "scatter", "accumulate",
          "compact")

_unread: list = []


def start(engine: str, device) -> "FrameProfile | None":
    """A new frame's profile when SRT_PROFILE=1, else None."""
    if os.environ.get("SRT_PROFILE") != "1":
        return None
    prof = FrameProfile(engine, torch.device(device))
    _unread.append(prof)
    return prof


def current() -> "FrameProfile | None":
    """The newest frame profile not yet reported, or None (always None
    with SRT_PROFILE unset)."""
    return _unread[-1] if _unread else None


def stage(prof: "FrameProfile | None", name: str):
    """The context of one stage: its trace range, and its marks when
    prof is a FrameProfile."""
    if prof is None:
        return record_function(f"srt.{name}")
    return prof.stage(name)


def sync(prof: "FrameProfile | None", name: str):
    """The context of one call that waits for the device: its trace
    range "srt.sync.<name>", and its count when prof is a
    FrameProfile. With neither a FrameProfile nor an active profiler it
    opens nothing: a wait falls where the card idles, and there a
    record_function range with no profiler (about 9 us of host time on
    an H100 machine's host) made the wavefront's frame 0.25 % slower."""
    if prof is not None:
        return prof.sync(name)
    if not torch._C._autograd._profiler_enabled():
        return contextlib.nullcontext()
    return record_function(f"srt.sync.{name}")


class FrameProfile:
    """The stage marks and waits of one frame. Each mark is
    (perf_counter, CUDA event or None); rows group the marks and the
    count of waits of one bounce."""

    def __init__(self, engine: str, device: torch.device):
        self.engine = engine
        self.cuda = device.type == "cuda"
        self.rows = []       # (label, counts, [(stage, mark, mark)], waits)
        self._pending = []   # marks since the last row
        self._syncs = 0      # waits since the last row

    def _mark(self):
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        return time.perf_counter(), ev

    @contextlib.contextmanager
    def stage(self, name: str):
        with record_function(f"srt.{name}"):
            a = self._mark()
            yield
            b = self._mark()
        self._pending.append((name, a, b))

    @contextlib.contextmanager
    def sync(self, name: str):
        with record_function(f"srt.sync.{name}"):
            yield
        self._syncs += 1

    def row(self, label: str, counts: str) -> None:
        """Close a row: the stages and waits since the last row, under
        label."""
        self.rows.append((label, counts, self._pending, self._syncs))
        self._pending, self._syncs = [], 0

    def _ms(self, a, b) -> float:
        if self.cuda:
            return a[1].elapsed_time(b[1])
        return (b[0] - a[0]) * 1e3

    def read(self) -> dict:
        """The frame's times, read after a synchronize of the device:
        {"engine", "rows": [(label, counts, {stage: ms}, ms from its
        first mark to its last, waits)], "stages": {stage: ms} summed
        over the frame, "stage_ms": their sum, "span_ms": first mark to
        last, "host_stage_ms": the host's clock summed over the stages,
        "syncs": the frame's waits}. Marks and waits after the last row
        form a row of their own ("tail")."""
        if self._pending or self._syncs:
            self.row("tail", "after the last bounce")
        rows, totals, host = [], {}, 0.0
        for label, counts, marks, syncs in self.rows:
            per = {}
            for name, a, b in marks:
                ms = self._ms(a, b)
                per[name] = per.get(name, 0.0) + ms
                totals[name] = totals.get(name, 0.0) + ms
                host += (b[0] - a[0]) * 1e3
            span = self._ms(marks[0][1], marks[-1][2]) if marks else 0.0
            rows.append((label, counts, per, span, syncs))
        marks = [m for row in self.rows for m in row[2]]
        span = self._ms(marks[0][1], marks[-1][2]) if marks else 0.0
        return {"engine": self.engine, "rows": rows, "stages": totals,
                "stage_ms": sum(totals.values()), "span_ms": span,
                "host_stage_ms": host,
                "syncs": sum(row[3] for row in self.rows)}


def _stage_text(per: dict, names) -> str:
    return ", ".join(f"{n} {per.get(n, 0.0):.3f}" for n in names) + " ms"


def report() -> list:
    """Print and return (FrameProfile.read()) the profile of every frame
    rendered in this process since the last call; the caller has
    synchronized the device. Under torch.distributed each line names
    the rank."""
    import torch.distributed as dist

    tag = (f"[profile rank {dist.get_rank()}]" if dist.is_initialized()
           else "[profile]")
    out = []
    while _unread:
        res = _unread.pop(0).read()
        names = [n for n in STAGES if n in res["stages"]] + [
            n for n in res["stages"] if n not in STAGES]
        prefix = "" if res["engine"] == "wavefront" else f"{res['engine']} "
        for label, counts, per, span, syncs in res["rows"]:
            print(f"{tag} {prefix}{label}: {span:.3f} ms, {counts}, syncs "
                  f"{syncs}; " + _stage_text(per, names), flush=True)
        print(f"{tag} {res['engine']} frame: {res['stage_ms']:.3f} ms in "
              f"stages, {res['span_ms']:.3f} ms from the first stage to "
              f"the last, syncs {res['syncs']}; "
              + _stage_text(res["stages"], names), flush=True)
        out.append(res)
    return out
