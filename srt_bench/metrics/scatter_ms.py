"""scatter_ms: device milliseconds of the port's srt.scatter ranges per
frame (the ranges' device spans in the trace, summed over the window)."""

from srt_bench import arith


def read(w):
    return arith.range_ms_per_frame(w, "srt.scatter")
