"""The port's numpy oracle and its numpy twins against the JAX
package's, bit for bit on seeded inputs, and the port's torch
Moller-Trumbore / brute-force intersector against the numpy twin."""

import numpy as np
import pytest
import torch

from sycl_ray_tracer_torch.models import camera as tcam
from sycl_ray_tracer_torch.models import oracle as toracle
from sycl_ray_tracer_torch.ops import intersect as tisect
from sycl_ray_tracer_torch.ops import rng as trng
from sycl_ray_tracer_torch.ops import sampling as tsamp
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils.gltf import load_glb

from tests.torch_common import tv3

torch.set_num_threads(2)

_U32 = np.uint32


def _words(seed: int, n: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 2**32, n, dtype=np.uint64
                                               ).astype(_U32)


def test_make_key_np_bit_exact():
    from sycl_ray_tracer_tpu.ops import rng as jrng

    seeds, lanes = _words(1, 4096), _words(2, 4096)
    assert np.array_equal(trng.make_key_np(seeds, lanes),
                          jrng.make_key_np(seeds, lanes))
    # the oracle's nesting: a scalar seed, then the lane
    inner = trng.make_key_np(_U32(7), _U32(3))
    assert np.array_equal(trng.make_key_np(inner, lanes),
                          jrng.make_key_np(jrng.make_key_np(_U32(7), _U32(3)),
                                           lanes))


@pytest.mark.parametrize("counter", [0, 1, 9, 0x55555557, 0x33333336])
def test_uniform_np_bit_exact(counter):
    from sycl_ray_tracer_tpu.ops import rng as jrng

    keys = _words(3, 4096)
    ctr = _U32(counter)
    a = trng.uniform_np(keys, ctr)
    assert a.dtype == np.float32
    assert np.array_equal(a, jrng.uniform_np(keys, ctr))
    for x, y in zip(trng.uniform3_np(keys, ctr), jrng.uniform3_np(keys, ctr)):
        assert x.dtype == np.float32 and np.array_equal(x, y)


def test_uniform_np_equals_torch():
    keys = _words(4, 4096)
    got = trng.uniform_np(keys, _U32(5))
    want = trng.uniform(torch.from_numpy(keys.astype(np.int64)), 5).numpy()
    assert np.array_equal(got, want)


def test_random_unit_vector_np_bit_exact():
    from sycl_ray_tracer_tpu.ops import sampling as jsamp

    keys = _words(5, 4096)
    for ctr in (_U32(2), _U32(11)):
        a = tsamp.random_unit_vector_np(keys, ctr)
        assert a.shape == (4096, 3)
        assert np.array_equal(a, jsamp.random_unit_vector_np(keys, ctr))


def test_generate_rays_np_bit_exact():
    from sycl_ray_tracer_tpu.models import camera as jcam

    host = load_glb(tfix.cube_scene_glb())
    args = (96, 64, host.camera_position, host.camera_direction,
            host.camera_focal_length)
    lane = np.arange(96 * 64, dtype=_U32)
    px = (lane % _U32(96)).astype(np.int32)
    py = (lane // _U32(96)).astype(np.int32)
    key = trng.make_key_np(trng.make_key_np(_U32(0), _U32(1)), lane)
    o, d = tcam.generate_rays_np(tcam.make_camera(*args, device="cpu"), px,
                                 py, key)
    jo, jd = jcam.generate_rays_np(jcam.make_camera(*args), px, py, key)
    assert np.array_equal(o, jo) and np.array_equal(d, jd)
    assert o.dtype == d.dtype == np.float32


def _random_scene(seed: int, n_tri: int, n_ray: int):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-3, 3, (n_tri, 3)).astype(np.float32)
    tri = c[:, None, :] + rs.uniform(-0.6, 0.6, (n_tri, 3, 3)).astype(
        np.float32)
    o = rs.uniform(-5, 5, (n_ray, 3)).astype(np.float32)
    d = rs.uniform(-1, 1, (n_ray, 3)).astype(np.float32)
    return tri, o, d


def test_intersect_brute_np_bit_exact():
    from sycl_ray_tracer_tpu.ops.intersect import intersect_brute_np as jbrute

    tri, o, d = _random_scene(6, 300, 1500)
    for t_max in (None, np.float32(4.0)):
        got = tisect.intersect_brute_np(o, d, tri, t_max)
        want = jbrute(o, d, tri, t_max)
        assert (got[1] >= 0).any()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    empty = tisect.intersect_brute_np(o, d, np.zeros((0, 3, 3), np.float32))
    assert (empty[1] == -1).all() and (empty[0] == np.float32(3e38)).all()


@pytest.mark.parametrize("chunk", [64, 2048])
def test_intersect_brute_torch_matches_np(chunk):
    tri, o, d = _random_scene(7, 300, 1500)
    hit = tisect.intersect_brute(tv3(o), tv3(d), torch.from_numpy(tri),
                                 chunk=chunk)
    t_b, id_b, u_b, v_b = tisect.intersect_brute_np(o, d, tri)
    ids = hit.tri.numpy()
    assert ((ids >= 0) == (id_b >= 0)).all() and (id_b >= 0).sum() > 100
    assert (ids == id_b).all()
    np.testing.assert_allclose(hit.t.numpy(), t_b, rtol=1e-6)
    np.testing.assert_allclose(hit.u.numpy(), u_b, atol=1e-5)
    np.testing.assert_allclose(hit.v.numpy(), v_b, atol=1e-5)


def test_moller_trumbore_matches_np():
    # rays aimed at barycentric points of one triangle, about half of
    # them inside it
    tri, o, _ = _random_scene(8, 1, 4000)
    bary = np.random.RandomState(9).uniform(-0.2, 0.7, (4000, 2)).astype(
        np.float32)
    p = (tri[0, 0] + bary[:, :1] * (tri[0, 1] - tri[0, 0])
         + bary[:, 1:] * (tri[0, 2] - tri[0, 0]))
    d = (p - o).astype(np.float32)
    tri = np.repeat(tri, 4000, axis=0)
    v0 = tri[:, 0]
    ok, t, u, v = tisect.moller_trumbore(
        tv3(o), tv3(d), tv3(v0), tv3(tri[:, 1] - v0), tv3(tri[:, 2] - v0),
        torch.full((4000,), tisect.BIG))
    t_b, id_b, _, _ = tisect.intersect_brute_np(o, d, tri[:1])
    ok = ok.numpy()
    assert (ok == (id_b >= 0)).all() and 0.3 < ok.mean() < 0.9
    np.testing.assert_allclose(t.numpy()[ok], t_b[ok], rtol=1e-6)


@pytest.mark.parametrize("name,size,spp,depth,rr", [
    ("triangle_scene_glb", 32, 2, 4, False),
    ("cube_scene_glb", 48, 2, 6, False),
    ("dielectric_scene_glb", 32, 4, 8, True),
])
def test_render_oracle_bit_exact(name, size, spp, depth, rr):
    from sycl_ray_tracer_tpu.models.camera import make_camera as jmake
    from sycl_ray_tracer_tpu.models.oracle import render_oracle as joracle
    from sycl_ray_tracer_tpu.utils.gltf import load_glb as jload

    glb = getattr(tfix, name)()
    host, jhost = load_glb(glb), jload(glb)
    args = (size, size, host.camera_position, host.camera_direction,
            host.camera_focal_length)
    kw = dict(width=size, height=size, spp=spp, max_depth=depth, seed=0,
              rr=rr)
    img = toracle.render_oracle(host, tcam.make_camera(*args, device="cpu"),
                                **kw)
    want = joracle(jhost, jmake(*args), **kw)
    assert img.shape == (size, size, 3) and img.dtype == np.float32
    assert img.max() > 0.1
    assert np.array_equal(img, want)
    assert toracle.rmse(img, want) == 0.0
