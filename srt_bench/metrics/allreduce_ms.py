"""allreduce_ms: rank 0's device milliseconds per frame of NCCL's
all-reduce kernels, the wait for the slowest rank included."""

from srt_bench import arith


def read(w):
    return arith.ops_ms_per_frame(
        w, lambda n: n.startswith("nccl") and "AllReduce" in n)
