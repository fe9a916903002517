"""Port intersector (ops/traverse8.py): the plain torch version against
the JAX package's Woop reference and CPU traversal, and the kernel's own
per-ray walk (csrc/traverse8.cuh, built here with g++) against the plain
version."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from sycl_ray_tracer_tpu.ops import woop as jwoop
from sycl_ray_tracer_torch.models import trace as ttrace
from sycl_ray_tracer_torch.ops import sah as tsah
from sycl_ray_tracer_torch.ops import traverse8 as t8
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils import procgen as tproc

from tests.torch_common import port_pair, tv3

_PAIRS = {}


def _pair(name):
    if name not in _PAIRS:
        glb = (tfix.cube_scene_glb() if name == "cube"
               else tproc.sponza_like_glb(scale=1))
        _PAIRS[name] = port_pair(glb)
    return _PAIRS[name]


def _rays(host, r, seed):
    """Half camera rays (origin at the camera), half from random points
    inside the scene bounds, random unit directions."""
    rs = np.random.RandomState(seed)
    o = np.broadcast_to(host.camera_position.astype(np.float32),
                        (r, 3)).copy()
    lo, hi = host.tri_v.reshape(-1, 3).min(0), host.tri_v.reshape(-1, 3).max(0)
    o[r // 2:] = rs.uniform(lo, hi, (r - r // 2, 3))
    d = rs.randn(r, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d


def _args(scene, o, d):
    return (scene.bvh_nodes, scene.bvh_child_ids, scene.bvh_woop,
            scene.sah_ni, tv3(o), tv3(d))


def test_plain_matches_woop_reference_on_cube():
    host, scene, _ = _pair("cube")
    rs = np.random.RandomState(3)
    r = 1024
    o = np.broadcast_to(host.camera_position.astype(np.float32),
                        (r, 3)).copy()
    d = rs.randn(r, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit = t8.traverse8(*_args(scene, o, d))   # CPU tensors -> plain
    rows = tsah.leaf_rows(host.tri_v, tsah.build_sah(host.tri_v).order, 8)
    tw, jw, uw, vw = jwoop.np_woop_hit(rows, o, d)
    miss = ~np.isfinite(tw)
    tri = hit.tri.numpy()
    assert miss.mean() > 0.05 and (~miss).mean() > 0.2
    assert ((tri < 0) == miss).all()
    assert (tri[~miss] == jw[~miss]).all()
    np.testing.assert_allclose(hit.t.numpy()[~miss], tw[~miss], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(hit.u.numpy()[~miss], uw[~miss], atol=1e-4)
    np.testing.assert_allclose(hit.v.numpy()[~miss], vw[~miss], atol=1e-4)
    assert (hit.t.numpy()[miss] == np.float32(3e38)).all()
    assert (hit.u.numpy()[miss] == 0).all() and (hit.v.numpy()[miss] == 0).all()
    # t_init chaining: nothing is strictly closer than the found t
    again = t8.traverse8(*_args(scene, o, d), t_init=hit.t)
    assert (again.tri.numpy() == -1).all()
    assert (again.t.numpy() == hit.t.numpy()).all()


def test_plain_inactive_lanes():
    host, scene, _ = _pair("cube")
    o, d = _rays(host, 512, 5)
    full = t8.traverse8_plain(*_args(scene, o, d))
    active = torch.from_numpy(np.random.RandomState(6).rand(512) < 0.5)
    t_init = torch.full((512,), 2.0)
    part = t8.traverse8_plain(*_args(scene, o, d), active=active,
                              t_init=t_init)
    ina = ~active
    assert (part.t[ina] == 0).all() and (part.tri[ina] == -1).all()
    assert (part.u[ina] == 0).all() and (part.v[ina] == 0).all()
    # active lanes: hits strictly below t_init, else t = t_init, tri -1
    near = active & (full.t < 2.0)
    assert (part.tri[near] == full.tri[near]).all()
    assert (part.t[near] == full.t[near]).all()
    far = active & ~(full.t < 2.0)
    assert (part.tri[far] == -1).all() and (part.t[far] == 2.0).all()


def test_plain_matches_jax_cpu_traversal_on_sponza():
    """Against the path the JAX package takes on the CPU: the Morton
    heap walk with Moller-Trumbore leaves (wbvh.traverse8). Both report
    canonical Morton slots after the SAH remap; Woop and MT t differ by
    up to ~5e-4 relative."""
    import jax.numpy as jnp

    from sycl_ray_tracer_tpu.models.scene import build_device_scene
    from sycl_ray_tracer_tpu.ops.vec import V3 as JV3
    from sycl_ray_tracer_tpu.ops.wbvh import traverse8 as jtraverse8
    from sycl_ray_tracer_tpu.utils.gltf import load_glb as jload

    host, scene, cam = _pair("sponza")
    js = build_device_scene(jload(tproc.sponza_like_glb(scale=1)),
                            leaf_size=8)
    # 2048 jittered camera rays from the port's queue generator, 2048
    # random rays
    from sycl_ray_tracer_torch.models.wavefront import _gen_queue
    q, _ = _gen_queue(cam, 0, 0, width=64, height=32)
    o_r, d_r = _rays(host, 2048, 9)
    o = np.concatenate([q[0:3].T.numpy(), o_r])
    d = np.concatenate([q[3:6].T.numpy(), d_r])
    assert o.shape == (4096, 3)

    hit = ttrace.intersect_scene(scene, tv3(o), tv3(d))
    jv = lambda a: JV3(*(jnp.asarray(a[:, i]) for i in range(3)))
    jh = jtraverse8(js.bvh_nodes, js.bvh_ni, js.bvh_depth, js.leaf_size,
                    jv(o), jv(d))
    tri, jtri = hit.tri.numpy(), np.asarray(jh.tri)
    agree = (tri >= 0) == (jtri >= 0)
    assert agree.mean() >= 0.999, agree.mean()
    both = (tri >= 0) & (jtri >= 0)
    assert both.mean() > 0.5
    np.testing.assert_allclose(hit.t.numpy()[both], np.asarray(jh.t)[both],
                               rtol=5e-4)
    far = both & (np.abs(hit.t.numpy() - np.asarray(jh.t))
                  > 5e-4 * np.abs(np.asarray(jh.t)))
    assert not far.any()


def _host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(t8.build_host_library())
    lib.srt_traverse8_host.restype = None
    lib.srt_traverse8_host.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int32] + [ctypes.c_void_p] * 12
        + [ctypes.c_int64])
    lib.srt_traverse8_stack.restype = ctypes.c_int
    assert lib.srt_traverse8_stack() == t8.STACK
    return lib


def _host_traverse(lib, scene, o, d, active=None, t_init=None):
    r = o.shape[0]
    ox, dx = tv3(o), tv3(d)
    out = (torch.empty(r), torch.empty(r, dtype=torch.int32),
           torch.empty(r), torch.empty(r))
    ptr = (lambda x: None if x is None else x.data_ptr())
    lib.srt_traverse8_host(
        scene.bvh_nodes.data_ptr(), scene.bvh_child_ids.data_ptr(),
        scene.bvh_woop.data_ptr(), scene.sah_ni,
        *(c.data_ptr() for c in (*ox, *dx)), ptr(active), ptr(t_init),
        *(x.data_ptr() for x in out), r)
    return out


@pytest.mark.parametrize("name,r", [("cube", 1024), ("sponza", 4096)])
def test_kernel_walk_host_build_matches_plain(name, r):
    """The per-ray walk the CUDA kernel runs, compiled for the CPU: tri
    ids equal outside 1e-6-relative t ties, t rtol 1e-4, u/v atol 1e-4,
    plus the t_init and inactive-lane semantics."""
    lib = _host_lib()
    host, scene, _ = _pair(name)
    o, d = _rays(host, r, 11)
    t, tri, u, v = _host_traverse(lib, scene, o, d)
    p = t8.traverse8_plain(*_args(scene, o, d))
    assert ((tri >= 0) == (p.tri >= 0)).all()
    hit = p.tri >= 0
    tie = (t - p.t).abs() <= 1e-6 * p.t.abs()
    assert not (hit & (tri != p.tri) & ~tie).any()
    np.testing.assert_allclose(t.numpy(), p.t.numpy(), rtol=1e-4)
    same = (hit & (tri == p.tri)).numpy()
    np.testing.assert_allclose(u.numpy()[same], p.u.numpy()[same], atol=1e-4)
    np.testing.assert_allclose(v.numpy()[same], p.v.numpy()[same], atol=1e-4)
    assert (u[~hit] == 0).all() and (v[~hit] == 0).all()

    _, tri2, _, _ = _host_traverse(lib, scene, o, d, t_init=t)
    assert (tri2 == -1).all()
    active = torch.from_numpy(np.random.RandomState(2).rand(r) < 0.5)
    t3, tri3, u3, v3 = _host_traverse(lib, scene, o, d, active=active)
    ina = ~active
    assert (t3[ina] == 0).all() and (tri3[ina] == -1).all()
    assert (u3[ina] == 0).all() and (v3[ina] == 0).all()
    assert (tri3[active] == tri[active]).all()
    assert (t3[active] == t[active]).all()


def test_wrapper_rejects_non_cpu_non_cuda_and_checks_stack():
    host, scene, _ = _pair("cube")
    o, d = _rays(host, 8, 1)
    meta = [x.to("meta") for x in (scene.bvh_nodes, scene.bvh_child_ids,
                                   scene.bvh_woop)]
    with pytest.raises(ValueError):
        t8.traverse8(*meta, scene.sah_ni, tv3(o), tv3(d))
