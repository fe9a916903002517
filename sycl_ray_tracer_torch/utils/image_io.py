"""PNG writeback (util.hpp:8-33 equivalent) through utils/png.py."""

from __future__ import annotations

import numpy as np

from sycl_ray_tracer_torch.utils.png import encode_png


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3] float32 in [0, 1] (already gamma-encoded, as the
    reference's kernel output is) -> 8-bit RGBA PNG, alpha=255."""
    u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    if u8.shape[-1] == 3:
        a = np.full(u8.shape[:2] + (1,), 255, np.uint8)
        u8 = np.concatenate([u8, a], axis=-1)
    with open(path, "wb") as f:
        f.write(encode_png(u8))
