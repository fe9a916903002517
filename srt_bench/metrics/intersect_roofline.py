"""intersect_roofline: the intersect kernels' share of their
roofline, in %: the least time in which the card moves the bytes that
the window's closest-hit queries need (arith.BYTES_PER_RAY for each ray
of the tallies) at its published memory bandwidth, over the kernels'
device time in the window (intersect_ms's operations). The tree's node and triangle tables, and the
box and triangle tests, are left out of the count: what they cost
depends on the tree that the program builds."""

from srt_bench import arith


def read(w):
    least = arith.least_intersect_s(w.rays, w.card)
    ms = arith.ops_ms_per_frame(w, arith.intersect_kernel)
    if least is None or not ms:
        return None
    return 100.0 * least / (ms * w.frames / 1e3)
