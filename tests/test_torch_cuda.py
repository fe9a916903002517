"""Tests of the port that need the card: the CUDA kernel against its
plain version, the wrapper's input checks, and a small render on cuda
against the same render on the cpu. They skip without a CUDA device.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sycl_ray_tracer_torch.models.wavefront import render_wavefront
from sycl_ray_tracer_torch.ops import traverse8 as t8
from sycl_ray_tracer_torch.ops.vec import V3
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils import procgen as tproc
from sycl_ray_tracer_torch.utils.gltf import load_glb
from sycl_ray_tracer_torch.models.scene import build_device_scene
from sycl_ray_tracer_torch.models.camera import make_camera

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rays(host, r, seed, dev):
    rs = np.random.RandomState(seed)
    o = np.broadcast_to(host.camera_position.astype(np.float32),
                        (r, 3)).copy()
    v = host.tri_v.reshape(-1, 3)
    o[r // 2:] = rs.uniform(v.min(0), v.max(0), (r - r // 2, 3))
    d = rs.randn(r, 3).astype(np.float32)
    t = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(
        dev) for i in range(3)))
    return t(o), t(d)


def test_kernel_matches_plain(cuda):
    """Exact ids outside 1e-6-relative t ties (-fmad=false makes the
    two round alike), t rtol 1e-4, u/v atol 1e-4, t_init chaining,
    inactive lanes, and one count per launch."""
    host = load_glb(tproc.sponza_like_glb(scale=1))
    scene = build_device_scene(host, device=cuda)
    o, d = _rays(host, 8192, 12, cuda)
    args = (scene.bvh_nodes, scene.bvh_child_ids, scene.bvh_woop,
            scene.sah_ni, o, d)
    before = t8.traverse8.launches
    k = t8.traverse8(*args)
    assert t8.traverse8.launches == before + 1
    p = t8.traverse8_plain(*args)
    hit = p.tri >= 0
    assert bool(((k.tri >= 0) == hit).all())
    tie = (k.t - p.t).abs() <= 1e-6 * p.t.abs()
    assert not bool((hit & (k.tri != p.tri) & ~tie).any())
    assert torch.allclose(k.t, p.t, rtol=1e-4)
    same = hit & (k.tri == p.tri)
    assert torch.allclose(k.u[same], p.u[same], atol=1e-4)
    assert torch.allclose(k.v[same], p.v[same], atol=1e-4)
    assert bool((t8.traverse8(*args, t_init=k.t).tri == -1).all())
    active = torch.rand(8192, device=cuda) < 0.5
    k3 = t8.traverse8(*args, active=active)
    assert bool((k3.t[~active] == 0).all())
    assert bool((k3.tri[~active] == -1).all())
    assert bool((k3.tri[active] == k.tri[active]).all())


def test_wrapper_rejects_bad_inputs(cuda):
    host = load_glb(tfix.cube_scene_glb())
    scene = build_device_scene(host, device=cuda)
    o, d = _rays(host, 64, 1, cuda)
    args = (scene.bvh_nodes, scene.bvh_child_ids, scene.bvh_woop,
            scene.sah_ni)
    with pytest.raises(ValueError):
        t8.traverse8(*args, o, V3(d.x, d.y, d.z.double()))
    with pytest.raises(ValueError):
        t8.traverse8(*args, o, V3(d.x, d.y, torch.stack([d.z, d.z],
                                                         1)[:, 0]))
    with pytest.raises(ValueError):
        t8.traverse8(*args, o, d, active=torch.ones(64, device=cuda))
    with pytest.raises(ValueError):
        t8.traverse8(*args, V3(o.x.cpu(), o.y, o.z), d)


def test_render_cuda_matches_cpu(cuda):
    host = load_glb(tfix.cube_scene_glb())
    kw = dict(width=48, height=48, spp=2, max_depth=6, seed=4)
    out = []
    for dev in (cuda, torch.device("cpu")):
        scene = build_device_scene(host, device=dev)
        cam = make_camera(48, 48, host.camera_position,
                          host.camera_direction, host.camera_focal_length,
                          device=dev)
        img, rays = render_wavefront(scene, cam, **kw)
        out.append((img.cpu().numpy(), rays.numpy()))
    (a, ra), (b, rb) = out
    assert (np.abs(ra - rb) <= np.maximum(16, 0.005 * rb)).all()
    d = np.abs(a - b).max(axis=-1)
    assert (d > 0.05).mean() < 5e-3
    assert float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2))) < 4e-3
