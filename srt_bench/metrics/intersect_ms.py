"""intersect_ms: device milliseconds per frame of the intersect entries'
device operations (arith.intersect_kernel: the kernels whose name
starts with "traverse", and the compaction of live lanes that an entry
launches first when given a mask)."""

from srt_bench import arith


def read(w):
    return arith.ops_ms_per_frame(w, arith.intersect_kernel)
