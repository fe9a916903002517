"""The stage and wait ranges of a profiler trace.

Each stage of a bounce runs inside `stage(name)`, a
torch.profiler.record_function range "srt.<name>", so a trace
(utils/cli.py:traced_frame, srt_bench/run.py) shows the stages by name
and times them on the device:

- generate: camera rays, once per wave (models/wavefront.py:
  accumulate_wavefront, models/megakernel.py:_wave);
- intersect: the traversal (models/wavefront.py:_bounce,
  models/trace.py:trace_step);
- shade: shading gathers, emission and the sky term, and scatter: the
  material's scatter and russian roulette (models/wavefront.py:
  _stages_plain and _stages_by_hand, models/trace.py:step_plain and
  step_by_hand);
- accumulate: the terminated rays into the pixels (the same functions,
  and models/megakernel.py:_wave);
- compact: the wavefront's sort key, sort and gather (models/
  wavefront.py:_bounce); the megakernel has no compaction and names its
  live-count read "count" (models/megakernel.py:_wave).

Each point where the host waits for the card inside a frame runs in
`sync(name)`, a range "srt.sync.<name>" around the blocking call alone,
opened only while a profiler runs. The waits:

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
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function


def stage(name: str):
    """The trace range "srt.<name>" of one stage."""
    return record_function(f"srt.{name}")


def sync(name: str):
    """The trace range "srt.sync.<name>" of one call that waits for the
    device, while a profiler runs. With no active profiler it opens
    nothing: a wait falls where the card idles, and there a
    record_function range with no profiler (about 9 us of host time on
    an H100 machine's host) made the wavefront's frame 0.25 % slower."""
    if not torch._C._autograd._profiler_enabled():
        return contextlib.nullcontext()
    return record_function(f"srt.sync.{name}")
