"""idle_pct: the share of the traced window, in %, in which no device
operation ran: 100 * (1 - union of the device operations' intervals /
the window)."""

from srt_bench import arith


def read(w):
    span = w.t1_us - w.t0_us
    if span <= 0 or not w.device_ops:
        return None
    return 100.0 * (1.0 - arith.busy_us(w) / span)
