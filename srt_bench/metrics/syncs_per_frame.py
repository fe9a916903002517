"""syncs_per_frame: the host's waits for the device per frame: the
program's srt.sync.<wait> host ranges (the port's utils/profile.py:sync)
that start inside the window, over the window's frames; nothing where
the trace holds no such range."""


def read(w):
    starts = [s for n, s, _ in w.host_ranges if n.startswith("srt.sync.")]
    if not starts or not w.frames:
        return None
    return sum(w.t0_us <= s < w.t1_us for s in starts) / w.frames
