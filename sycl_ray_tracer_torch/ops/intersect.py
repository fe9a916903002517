"""Hit record and intersection constants.

Conventions match Embree's as the reference uses them: t is measured in
units of the (possibly unnormalized) ray direction with tnear = 1e-4
(camera.hpp:46-62), and barycentrics (u, v) weight vertices 1 and 2
while w = 1-u-v weights vertex 0 (trace_ray.hpp:48-55).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TNEAR = 1e-4  # camera.hpp:51 (RTCRay.tnear)
_DET_EPS = 1e-12
BIG = 3.0e38


class Hit(NamedTuple):
    t: torch.Tensor      # [R] float32
    tri: torch.Tensor    # [R] int64 or int32, -1 when miss
    u: torch.Tensor      # [R] float32
    v: torch.Tensor      # [R] float32
