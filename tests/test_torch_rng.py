"""Port RNG and camera: bit-exact against the JAX package's numpy twins
and JAX functions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sycl_ray_tracer_tpu.models import camera as jcam
from sycl_ray_tracer_tpu.ops import rng as jrng
from sycl_ray_tracer_tpu.ops import sampling as jsamp
from sycl_ray_tracer_torch.models import camera as tcam
from sycl_ray_tracer_torch.ops import rng as trng
from sycl_ray_tracer_torch.ops import sampling as tsamp

from tests import torch_common  # noqa: F401  (thread count)


def _lanes():
    """1e5 lanes: a random spread plus the edge words 0 and 2^32-1."""
    rs = np.random.RandomState(7)
    lanes = rs.randint(0, 2 ** 32, size=100_000, dtype=np.uint64)
    lanes[:4] = [0, 1, 0xFFFFFFFE, 0xFFFFFFFF]
    return lanes.astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_make_key_bit_exact(seed):
    lanes = _lanes()
    ref = jrng.make_key_np(np.uint32(seed), lanes)
    out = trng.make_key(seed, _t(lanes)).numpy()
    assert out.min() >= 0 and out.max() <= 0xFFFFFFFF
    assert (out.astype(np.uint32) == ref).all()
    jx = np.asarray(jrng.make_key(jnp.uint32(seed), jnp.asarray(lanes)))
    assert (out.astype(np.uint32) == jx).all()
    # tensor seeds broadcast the same way
    out2 = trng.make_key(_t(np.full(lanes.shape, seed, np.uint32)),
                         _t(lanes)).numpy()
    assert (out2 == out).all()


@pytest.mark.parametrize("counter", [0, 1, 12, 0x55555557, 0xFFFFFFFF])
def test_uniform_bit_exact(counter):
    keys = _lanes()
    ref = jrng.uniform_np(keys, np.uint32(counter))
    out = trng.uniform(_t(keys), counter).numpy()
    assert out.dtype == np.float32
    assert (out == ref).all()
    jx = np.asarray(jrng.uniform(jnp.asarray(keys), counter))
    assert (out == jx).all()


def test_uniform3_and_unit_vector_bit_exact():
    keys = _lanes()
    for c in (0, 3, 0xFFFFFFFF):
        ref = jrng.uniform3_np(keys, np.uint32(c))
        out = trng.uniform3(_t(keys), c)
        jx = jrng.uniform3(jnp.asarray(keys), c)
        for a, b, j in zip(out, ref, jx):
            assert (a.numpy() == b).all()
            assert (a.numpy() == np.asarray(j)).all()
    # The cube draws are bit-exact (above); the normalize differs in its
    # last bits because XLA's CPU rsqrt is not correctly rounded (it
    # agrees with 1/sqrt in float64 on ~87% of inputs) and torch's is a
    # different rounding, so the unit vectors agree to 2 ulp of 1.0
    # (the JAX package's own jnp-vs-numpy check allows 1e-7).
    v = np.stack([c.numpy() for c in tsamp.random_unit_vector(_t(keys), 5)],
                 -1)
    vj = np.stack([np.asarray(c) for c in
                   jsamp.random_unit_vector(jnp.asarray(keys), 5)], -1)
    vn = jsamp.random_unit_vector_np(keys, np.uint32(5))
    for ref in (vj, vn):
        np.testing.assert_allclose(v, ref, rtol=0,
                                   atol=2 * np.spacing(np.float32(1)))


def test_generate_rays_match_numpy_twin():
    w, h = 160, 90
    pos, dirn = (0.3, 2.2, 28.0), (0.05, -0.1, -1.0)
    jc = jcam.make_camera(w, h, pos, dirn, 1.7)
    tc = tcam.make_camera(w, h, pos, dirn, 1.7, device="cpu")
    for a, b in zip(jc[:4], tc[:4]):
        assert (np.asarray(a) == b.numpy()).all()
    pix = np.arange(w * h, dtype=np.int64)
    px, py = pix % w, pix // w
    key = jrng.make_key_np(np.uint32(3), pix.astype(np.uint32))
    o_ref, d_ref = jcam.generate_rays_np(jc, px, py, key)
    o, d = tcam.generate_rays(tc, torch.from_numpy(px),
                              torch.from_numpy(py), _t(key))
    # jitter bits are exactly those of the twin
    jx = trng.uniform(_t(key), 0).numpy() - np.float32(0.5)
    assert (jx == jrng.uniform_np(key, np.uint32(0)) - np.float32(0.5)).all()
    assert (np.stack([c.numpy() for c in o], -1) == o_ref).all()
    d_out = np.stack([c.numpy() for c in d], -1)
    ulp = np.spacing(np.abs(d_ref).astype(np.float32))
    assert (np.abs(d_out - d_ref) <= ulp).all()
