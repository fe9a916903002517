"""sync_idle_ms: device-idle milliseconds per frame in the idle gaps of
the window (arith.gaps over the device operations, clipped to the
window) whose start lies inside one of the program's srt.sync.<wait>
host ranges (the port's utils/profile.py:sync): the idle that the
host's waits for the device leave. Nothing where the trace holds no
device operation (the CPU) or no such range.

No margin is added for the alignment of the host's and the device's
clocks: on an H100, counting also the gaps that start up to 20 us after
a range ends added at most 1.4 % to the reading. The ranges of one
thread follow one another and never nest, so the only range that can
hold a gap's start is the last one to start at or before it."""

import bisect

from srt_bench import arith


def read(w):
    syncs = sorted((s, e) for n, s, e in w.host_ranges
                   if n.startswith("srt.sync."))
    if not w.device_ops or not syncs or not w.frames:
        return None
    starts = [s for s, _ in syncs]
    idle = 0.0
    for gs, ge in arith.gaps([(s, e) for _, s, e in w.device_ops],
                             w.t0_us, w.t1_us):
        i = bisect.bisect_right(starts, gs) - 1
        if i >= 0 and gs < syncs[i][1]:
            idle += ge - gs
    return idle / 1e3 / w.frames
