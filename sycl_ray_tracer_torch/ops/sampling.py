"""Random direction sampling.

``random_unit_vector`` is normalize(uniform cube in [-1,1]^3), the
reference's distribution (xorshift.hpp:38-40): deliberately not
rejection-sampled or cosine-weighted, so that the port, the JAX
package and the numpy oracle share one estimator.
"""

from __future__ import annotations

from sycl_ray_tracer_torch.ops import rng as _rng
from sycl_ray_tracer_torch.ops.vec import V3, normalize

# Guards the measure-zero all-components-exactly-0.5 draw.
_EPS = 1e-20


def random_unit_vector(key, counter) -> V3:
    u, v, w = _rng.uniform3(key, counter)
    cube = V3(u * 2.0 - 1.0, v * 2.0 - 1.0, w * 2.0 - 1.0)
    return normalize(cube, eps=_EPS)
