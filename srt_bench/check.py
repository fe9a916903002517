"""The comparison that decides a run's `correct`.

After the window, one of its frames, drawn from the seed, is held
against the plain reference (reference/render.py) at a sample of its
pixels, also drawn from the seed: one pixel in each cell of a grid over
the frame. The reference works each sampled pixel out on its own, over
all of the frame's samples and bounces, from the same GLB bytes and the
same frame seed. Two numbers are compared, each with its limit from
limits/<cell>.json:

- pixel_q90: the 90th percentile, over the sampled pixels, of the
  largest gap of a channel between the frame and the reference (gamma
  encoded). Where two triangles tie at a bit-equal t, as the coplanar
  faces of voxels do, the program's tree and the reference's may pick
  different ones, and that pixel's paths go their own way: the
  percentile lets such pixels be, while a fault that moves most pixels
  (a wrong estimator, a precision too low, samples left out) moves it;
- tally_gap: the largest gap, over the bounces, between the share of
  the frame's paths live at that bounce by the program's tallies (the
  whole frame) and by the reference's (the sampled pixels).
"""

from __future__ import annotations

import math

import numpy as np


def sample_pixels(seed: int, width: int, height: int, grid):
    """(px, py) int64 arrays: one pixel drawn from the seed in each cell
    of a grid = (gx, gy) of equal cells over the frame (at most one
    cell a pixel)."""
    gx, gy = min(grid[0], width), min(grid[1], height)
    rng = np.random.default_rng(seed)
    x0 = (np.arange(gx) * width) // gx
    x1 = (np.arange(1, gx + 1) * width) // gx
    y0 = (np.arange(gy) * height) // gy
    y1 = (np.arange(1, gy + 1) * height) // gy
    px = rng.integers(np.tile(x0, gy), np.tile(x1, gy))
    py = rng.integers(np.repeat(y0, gx), np.repeat(y1, gx))
    return px.astype(np.int64), py.astype(np.int64)


def compare(ours, ref, frame_tallies, ref_tallies, frame_paths: int,
            ref_paths: int, limits: dict) -> dict:
    """{name: {"value", "limit"}} of the two numbers; a value that is
    not finite reads as infinity."""
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    gap = np.abs(ours - ref).max(axis=1)
    q90 = float(np.quantile(gap, 0.9)) if np.isfinite(gap).all() \
        else math.inf
    a = np.asarray(frame_tallies, np.float64) / frame_paths
    b = np.asarray(ref_tallies, np.float64) / ref_paths
    tally = float(np.abs(a - b).max()) if a.shape == b.shape else math.inf
    values = {"pixel_q90": q90, "tally_gap": tally}
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
