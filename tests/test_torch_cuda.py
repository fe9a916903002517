"""Tests of the port that need the card: the CUDA kernels against their
plain versions and their host builds (at ray counts around a warp, and
under masks), the bounce stages' shade and scatter kernels against the
plain torch stages (at lane counts around a warp, under done masks, with
russian roulette off and on) and their launches per bounce, the
wavefront's compaction by hand against the plain compaction (at lane
counts around a block, with no lane live, and on every bounce of small
frames of a baked and a two-level scene) and its launches per bounce,
the wrappers' input checks, small renders (baked,
Morton heap through the megakernel, and two-level instanced, the voxel
scene's included) on cuda against the same renders on the cpu, traverse5
itf against its plain walk on that scene's bounce rays, the measuring
entry points (a
tiny in-process sweep and a profiler trace), and the host's waits: every
synchronizing call of a small frame of either engine inside a
utils/profile.py:sync range. They skip without a CUDA device.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import dataclasses

from sycl_ray_tracer_torch.models import materials as tmats
from sycl_ray_tracer_torch.models import trace as ttrace
from sycl_ray_tracer_torch.models import wavefront as twf
from sycl_ray_tracer_torch.models.instanced import (
    build_instanced_device_scene)
from sycl_ray_tracer_torch.models.megakernel import render_megakernel
from sycl_ray_tracer_torch.models.wavefront import render_wavefront
from sycl_ray_tracer_torch.ops import sah as tsah
from sycl_ray_tracer_torch.ops import traverse1 as t1
from sycl_ray_tracer_torch.ops import traverse5 as t5
from sycl_ray_tracer_torch.ops import traverse8 as t8
from sycl_ray_tracer_torch.utils.instanced import load_glb_instanced
from sycl_ray_tracer_torch.ops.vec import V3
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils import procgen as tproc
from sycl_ray_tracer_torch.utils.gltf import load_glb
from sycl_ray_tracer_torch.models.scene import build_device_scene
from sycl_ray_tracer_torch.models.camera import make_camera
from sycl_ray_tracer_torch.ops import compact
from sycl_ray_tracer_torch.ops import kernels
from sycl_ray_tracer_torch.ops import vertex

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


def _t5_tables(mode, dev):
    """traverse5's tables on `dev`: MT mode on the baked SAH tree of
    sponza scale 1, itf mode on the instanced fixture (r = 200)."""
    if mode == "mt":
        host = load_glb(tproc.sponza_like_glb(scale=1))
        scene = build_device_scene(host, device=dev)
        order = tsah.build_sah(host.tri_v, 8).order
        mt = torch.from_numpy(tsah.slot_rows(
            tsah.leaf_rows(host.tri_v, order, 8), 8)).to(dev)
        return (scene.bvh_nodes, scene.bvh_child_ids, mt, scene.sah_ni,
                {}), host.tri_v.reshape(-1, 3)
    ih = load_glb_instanced(tfix.instanced_scene_glb(200))
    scene = build_instanced_device_scene(ih, device=dev)
    return (scene.bvh_nodes, scene.bvh_child_ids, scene.bvh_mt,
            scene.sah_ni, dict(leaf_slot=scene.inst_leaf_slot,
                               leaf_xf=scene.inst_xf)), ih.inst_mat[:, :3, 3]


@pytest.mark.parametrize("mode", ["mt", "itf"])
def test_traverse5_kernel_matches_plain(cuda, mode):
    """As test_kernel_matches_plain, for traverse5 in both modes."""
    (nodes, ids, mt, ni, kw), pts = _t5_tables(mode, cuda)
    rs = np.random.RandomState(13)
    r = 8192
    o = rs.uniform(pts.min(0), pts.max(0), (r, 3)).astype(np.float32)
    d = rs.randn(r, 3).astype(np.float32)
    t = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(
        cuda) for i in range(3)))
    args = (nodes, ids, mt, ni, t(o), t(d))
    before = t5.traverse5.launches
    k = t5.traverse5(*args, **kw)
    assert t5.traverse5.launches == before + 1
    p = t5.traverse5_plain(*args, **kw)
    hit = p.tri >= 0
    assert 0.2 < float(hit.float().mean()) < 1.0
    assert bool(((k.tri >= 0) == hit).all())
    tie = (k.t - p.t).abs() <= 1e-6 * p.t.abs()
    assert not bool((hit & (k.tri != p.tri) & ~tie).any())
    assert torch.allclose(k.t, p.t, rtol=1e-4)
    same = hit & (k.tri == p.tri)
    assert torch.allclose(k.u[same], p.u[same], atol=1e-4)
    assert torch.allclose(k.v[same], p.v[same], atol=1e-4)
    assert bool((t5.traverse5(*args, t_init=k.t, **kw).tri == -1).all())
    active = torch.rand(r, device=cuda) < 0.5
    k3 = t5.traverse5(*args, active=active, **kw)
    assert bool((k3.t[~active] == 0).all())
    assert bool((k3.tri[~active] == -1).all())
    assert bool((k3.tri[active] == k.tri[active]).all())


def test_traverse5_wrapper_rejects_bad_inputs(cuda):
    (nodes, ids, mt, ni, kw), _ = _t5_tables("itf", cuda)
    o = V3(*(torch.zeros(64, device=cuda) for _ in range(3)))
    d = V3(*(torch.ones(64, device=cuda) for _ in range(3)))
    with pytest.raises(ValueError):
        t5.traverse5(nodes, ids, mt[:-1], ni, o, d, **kw)
    with pytest.raises(ValueError):
        t5.traverse5(nodes, ids, mt, ni, o, d,
                     leaf_slot=kw["leaf_slot"].long(), leaf_xf=kw["leaf_xf"])
    with pytest.raises(ValueError):
        t5.traverse5(nodes, ids, mt, ni, o, d, leaf_slot=kw["leaf_slot"],
                     leaf_xf=kw["leaf_xf"][:, :9].contiguous())
    with pytest.raises(ValueError):
        t5.traverse5(nodes, ids, mt, ni, o, d, leaf_slot=kw["leaf_slot"])
    with pytest.raises(ValueError):
        t5.traverse5(nodes, ids, mt, ni, V3(o.x.cpu(), o.y, o.z), d, **kw)


def test_instanced_render_cuda_matches_cpu(cuda):
    ih = load_glb_instanced(tfix.instanced_scene_glb(30))
    kw = dict(width=48, height=48, spp=8, max_depth=6, seed=4)
    out = []
    for dev in (cuda, torch.device("cpu")):
        scene = build_instanced_device_scene(ih, device=dev)
        cam = make_camera(48, 48, ih.camera_position, ih.camera_direction,
                          ih.camera_focal_length, device=dev)
        before = t5.traverse5.launches
        img, rays = render_wavefront(scene, cam, **kw)
        launched = t5.traverse5.launches - before
        out.append((img.cpu().numpy(), rays.numpy(), launched))
    (a, ra, la), (b, rb, lb) = out
    assert la == int((ra > 0).sum()) and lb == 0
    assert (np.abs(ra - rb) <= np.maximum(16, 0.005 * rb)).all()
    d = np.abs(a - b).max(axis=-1)
    assert (d > 0.05).mean() < 5e-3
    assert float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2))) < 4e-3


_VOXEL_FRAME = dict(spp=8, max_depth=10, seed=123456789)


def _voxel_pair(dev):
    """(scene, camera maker) of minecraft_like_glb(n=72) on `dev`: water
    and stone blocks coincide where its terrain lies at height 1, so
    many rays meet two faces at a bit-equal t."""
    ih = load_glb_instanced(tproc.minecraft_like_glb(n=72))
    scene = build_instanced_device_scene(ih, device=dev)
    return scene, lambda w, h: make_camera(
        w, h, ih.camera_position, ih.camera_direction,
        ih.camera_focal_length, device=dev)


@pytest.mark.parametrize("engine", ["wavefront", "megakernel"])
def test_voxel_render_cuda_matches_cpu(cuda, engine):
    """The two-level frames of minecraft_like_glb(n=72) at 96x54, 8 spp,
    depth 10 on the card against the same frames on the CPU, within the
    flip tail of test_instanced_render_cuda_matches_cpu. Without the
    walks' tie rule (csrc/bvh8_walk.cuh) the kernel's depth-first walk
    took the stone block where the plain walk took the water, and the
    tallies parted by up to 3 % of the paths."""
    render = render_wavefront if engine == "wavefront" else \
        render_megakernel
    out = []
    for dev in (cuda, torch.device("cpu")):
        scene, cam = _voxel_pair(dev)
        img, rays = render(scene, cam(96, 54), width=96, height=54,
                           **_VOXEL_FRAME)
        out.append((img.cpu().numpy(), rays.numpy()))
    (a, ra), (b, rb) = out
    assert (np.abs(ra - rb) <= np.maximum(16, 0.005 * rb)).all(), (ra, rb)
    d = np.abs(a - b).max(axis=-1)
    assert (d > 0.05).mean() < 5e-3
    assert float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2))) < 4e-3


def test_traverse5_itf_matches_plain_on_voxel_bounces(cuda, monkeypatch):
    """traverse5 in itf mode on the card against traverse5_plain on the
    CPU, on the rays of every bounce of a card frame of
    minecraft_like_glb(n=72): t equal on every ray, and ids, u and v
    equal at ties too, since both walks keep the least (t, id) hit; the
    one case the rule leaves to the walk's order (csrc/bvh8_walk.cuh,
    5 in 2M minecraft_proc rays) may flip at most 1 in 10,000 hits of
    the frame."""
    scene, cam = _voxel_pair(cuda)
    real = ttrace.traverse5
    calls = []

    def both(*args, **kw):
        hit = real(*args, **kw)
        cpu = [V3(*(c.cpu() for c in a)) if isinstance(a, V3) else
               a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        plain = t5.traverse5_plain(*cpu, **{
            k: None if v is None else v.cpu() for k, v in kw.items()})
        calls.append((type(hit)(*(c.cpu() for c in hit)), plain))
        return hit

    monkeypatch.setattr(ttrace, "traverse5", both)
    render_wavefront(scene, cam(48, 27), width=48, height=27,
                     **_VOXEL_FRAME)
    assert len(calls) == _VOXEL_FRAME["max_depth"]
    hits = flips = 0
    for hit, plain in calls:
        assert torch.equal(hit.t, plain.t)
        hits += int((plain.tri >= 0).sum())
        flips += int(((hit.tri != plain.tri) | (hit.u != plain.u)
                      | (hit.v != plain.v)).sum())
    assert hits > 0 and flips <= hits // 10000, (hits, flips)


@pytest.mark.parametrize("k", [1, 4])
def test_traverse1_kernel_matches_plain(cuda, k):
    """traverse1 on the Morton heap of sponza scale 1 at leaf size k,
    against traverse1_plain with the rules of test_kernel_matches_plain
    (no t_init: v1 has none)."""
    host = load_glb(tproc.sponza_like_glb(scale=1))
    scene = build_device_scene(host, leaf_size=k, device=cuda)
    o, d = _rays(host, 8192, 14, cuda)
    args = (scene.bvh_children, scene.bvh_leaves, scene.bvh_ni, k, o, d)
    before = t1.traverse1.launches
    kh = t1.traverse1(*args)
    assert t1.traverse1.launches == before + 1
    p = t1.traverse1_plain(*args)
    hit = p.tri >= 0
    assert 0.2 < float(hit.float().mean()) < 1.0
    assert bool(((kh.tri >= 0) == hit).all())
    tie = (kh.t - p.t).abs() <= 1e-6 * p.t.abs()
    assert not bool((hit & (kh.tri != p.tri) & ~tie).any())
    assert torch.allclose(kh.t, p.t, rtol=1e-4)
    same = hit & (kh.tri == p.tri)
    assert torch.equal(kh.u[same], p.u[same])
    assert torch.equal(kh.v[same], p.v[same])
    active = torch.rand(8192, device=cuda) < 0.5
    k3 = t1.traverse1(*args, active=active)
    assert bool((k3.t[~active] == 0).all())
    assert bool((k3.tri[~active] == -1).all())
    assert bool((k3.tri[active] == kh.tri[active]).all())
    with pytest.raises(ValueError):
        t1.traverse1(scene.bvh_children, scene.bvh_leaves[:, :-1], scene.bvh_ni,
                     k, o, d)


def test_megakernel_heap_cuda_matches_cpu(cuda):
    """The cube at leaf size 4 through the megakernel (traverse1 every
    bounce) on cuda and on the cpu: the image gate, and tallies within
    the flip tail."""
    kw = dict(width=96, height=96, spp=4, max_depth=8, seed=0)
    out = []
    for dev in (cuda, torch.device("cpu")):
        scene, _, cam = tfix.load_pair(tfix.cube_scene_glb(), 96, 96,
                                       device=dev)
        before = t1.traverse1.launches
        img, rays = render_megakernel(scene, cam, **kw)
        out.append((img.cpu().numpy(), rays.numpy(),
                    t1.traverse1.launches - before))
    (a, ra, la), (b, rb, lb) = out
    assert la == int((ra > 0).sum()) and lb == 0
    assert (np.abs(ra - rb) <= np.maximum(16, 0.005 * rb)).all()
    d = np.abs(a - b).max(axis=-1)
    assert (d > 0.05).mean() < 5e-3
    assert float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2))) < 4e-3


_CASES = {}


def _kernel_case(name, dev):
    """(camera position, points spanning the scene, kernel tables, host
    tables, kernel, plain, keyword tables) of one kernel: traverse8 (SAH
    tree) or traverse1 (Morton heap, K = 4) on sponza scale 1,
    traverse5-mt on the MT rows of the same SAH tree, traverse5-itf on
    the instanced fixture (r = 200)."""
    if name not in _CASES:
        kw = {}
        if name == "traverse5-itf":
            ih = load_glb_instanced(tfix.instanced_scene_glb(200))
            sc = build_instanced_device_scene(ih, device=dev)
            cam, pts = ih.camera_position, ih.inst_mat[:, :3, 3]
        else:
            host = load_glb(tproc.sponza_like_glb(scale=1))
            cam, pts = host.camera_position, host.tri_v.reshape(-1, 3)
        if name == "traverse8":
            sc = build_device_scene(host, device=dev)
            tabs = [sc.bvh_nodes, sc.bvh_child_ids, sc.bvh_woop, sc.sah_ni]
            kern, plain = t8.traverse8, t8.traverse8_plain
            ktabs = tabs
        elif name == "traverse1":
            sc = build_device_scene(host, leaf_size=4, device=dev)
            tabs = [sc.bvh_children, sc.bvh_leaves, sc.bvh_ni, 4,
                    sc.bvh_leaves.shape[0]]
            kern, plain = t1.traverse1, t1.traverse1_plain
            ktabs = tabs[:4]
        else:
            if name == "traverse5-mt":
                (nodes, ids, mt, ni, kw), _ = _t5_tables("mt", dev)
            else:
                nodes, ids, mt, ni = (sc.bvh_nodes, sc.bvh_child_ids,
                                      sc.bvh_mt, sc.sah_ni)
                kw = dict(leaf_slot=sc.inst_leaf_slot, leaf_xf=sc.inst_xf)
            ktabs = [nodes, ids, mt, ni]
            tabs = [nodes, ids, mt, kw.get("leaf_slot"), kw.get("leaf_xf"),
                    ni]
            kern, plain = t5.traverse5, t5.traverse5_plain
        _CASES[name] = (cam, pts, ktabs, tabs, kern, plain, kw)
    return _CASES[name]


def _case_rays(cam, pts, r, seed, dev):
    """Half the rays from the camera, half from random points in the
    box of `pts`; random unnormalized directions."""
    rs = np.random.RandomState(seed)
    o = np.broadcast_to(cam.astype(np.float32), (r, 3)).copy()
    o[r // 2:] = rs.uniform(pts.min(0), pts.max(0), (r - r // 2, 3))
    d = rs.randn(r, 3).astype(np.float32)
    t = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(
        dev) for i in range(3)))
    return t(o), t(d)


def _hold(name, dev, r, active=None, seed=15):
    """The kernel on r rays (and a mask) against plain (ids equal outside
    1e-6-relative t ties, t, u, v equal bit for bit where they agree)
    and against its host build (equal bit for bit, ties included). In
    itf mode two hits also tie when their points on the ray lie within
    1e-6 of the coordinates' scale (|o| + t |d|): an instance's node box,
    rounded to f32, can prune the closer of two such hits once the walk
    has found the other (chip_smoke.py:compare_hits)."""
    cam, pts, ktabs, tabs, kern, plain, kw = _kernel_case(name, dev)
    o, d = _case_rays(cam, pts, r, seed, dev)
    mask = {} if active is None else dict(active=active)
    before = kern.launches
    k = kern(*ktabs, o, d, **kw, **mask)
    assert kern.launches == before + 1
    p = plain(*ktabs, o, d, **kw, **mask)
    torch.cuda.synchronize()
    assert torch.equal(k.tri >= 0, p.tri >= 0)
    tie = (k.t - p.t).abs() <= 1e-6 * p.t.abs()
    if name == "traverse5-itf":
        dlen = torch.stack(list(d), 1).norm(dim=1)
        scale = (torch.stack(list(o), 1).abs().amax(1)
                 + torch.where(p.tri >= 0, p.t, 0.0) * dlen)
        tie |= (k.t - p.t).abs() * dlen <= 1e-6 * scale
    same = k.tri == p.tri
    assert not bool((~same & ~tie).any())
    for a, b in ((k.t, p.t), (k.u, p.u), (k.v, p.v)):
        assert torch.equal(a[same], b[same])
    cpu = lambda v: V3(*(c.cpu() for c in v))
    h = kernels.run_host(
        name.split("-")[0],
        [x.cpu() if isinstance(x, torch.Tensor) else x for x in tabs],
        cpu(o), cpu(d), None if active is None else active.cpu())
    for a, b in zip(h, k):
        assert torch.equal(a, b.cpu())
    return k


_KERNELS = ["traverse8", "traverse1", "traverse5-mt", "traverse5-itf"]


@pytest.mark.parametrize("name", _KERNELS)
@pytest.mark.parametrize("r", [0, 1, 31, 33, 1 << 20])
def test_kernel_matches_plain_and_host_at_ray_counts(cuda, name, r):
    k = _hold(name, cuda, r)
    assert k.t.shape == (r,)


@pytest.mark.parametrize("name", _KERNELS)
@pytest.mark.parametrize("mask", ["none", "sparse", "last_of_warp"])
def test_kernel_matches_plain_and_host_under_masks(cuda, name, mask):
    """No lane active, 5 % at random, and only the last lane of each
    warp: the live lanes are compacted before the walk, the others
    report (0, -1, 0, 0)."""
    r = 65536
    lane = torch.arange(r, device=cuda)
    gen = torch.Generator(device="cpu").manual_seed(17)
    active = {"none": torch.zeros(r, dtype=torch.bool, device=cuda),
              "sparse": (torch.rand(r, generator=gen) < 0.05).to(cuda),
              "last_of_warp": lane % 32 == 31}[mask]
    k = _hold(name, cuda, r, active)
    ina = ~active
    assert bool((k.t[ina] == 0).all()) and bool((k.tri[ina] == -1).all())
    assert bool((k.u[ina] == 0).all()) and bool((k.v[ina] == 0).all())


def _order_case(dev, r, mask, seed=19):
    """r rays of traverse8's case (half from the camera, half from points
    in the scene) and a mask: none, all or a ragged 61 % of the lanes
    live."""
    cam, pts, ktabs, *_ = _kernel_case("traverse8", dev)
    o, d = _case_rays(cam, pts, r, seed, dev)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    active = {"dead": torch.zeros(r, dtype=torch.bool),
              "live": torch.ones(r, dtype=torch.bool),
              "ragged": torch.rand(r, generator=gen) < 0.61}[mask].to(dev)
    return ktabs, o, d, active


def _scene_box(dev):
    host = load_glb(tproc.sponza_like_glb(scale=1))
    sc = build_device_scene(host, device=dev)
    return sc.scene_lo, sc.scene_hi


@pytest.mark.parametrize("r", [0, 1, 255, 256, 257, 1 << 20])
@pytest.mark.parametrize("mask", ["dead", "live", "ragged"])
def test_order_lists_live_lanes_by_bucket(cuda, r, mask):
    """The ordering kernels alone: the list's first `live` entries are
    the live lanes, each once, in ascending bucket (the plain buckets,
    the top ORDER_BITS bits of the wavefront's sort key; the order within
    a bucket is free), each record holding its lane's ray bit for bit,
    and the inactive lanes report (0, -1, 0, 0)."""
    _, o, d, active = _order_case(cuda, r, mask)
    lo, hi = _scene_box(cuda)
    rec, live, hit = t8.order(o, d, active, lo, hi)
    torch.cuda.synchronize()
    m = int(live)
    assert m == int(active.sum())
    got = t8.record_lanes(rec, m)
    assert torch.equal(torch.sort(got).values,
                       active.nonzero().squeeze(1))
    rays = torch.stack([c[got] for c in (*o, *d)], 1)
    assert torch.equal(rec[:m, :6].view(torch.int32), rays.view(torch.int32))
    b = t8.order_buckets(o, d, lo, hi)[got]
    assert bool((b[1:] >= b[:-1]).all())
    assert torch.equal(torch.sort(b).values, torch.sort(
        t8.order_buckets(o, d, lo, hi)[t8.order_plain(o, d, active, lo,
                                                       hi)]).values)
    ina = ~active
    assert bool((hit.t[ina] == 0).all()) and bool((hit.tri[ina] == -1).all())
    assert bool((hit.u[ina] == 0).all()) and bool((hit.v[ina] == 0).all())
    if r == 1 << 20 and mask != "dead":
        assert len(torch.unique(b)) > 1000


@pytest.mark.parametrize("r", [1, 257, 1 << 20])
@pytest.mark.parametrize("mask", ["dead", "live", "ragged"])
def test_ordered_traverse8_matches_lane_order(cuda, r, mask):
    """The masked traverse8 launch with the scene's box (its live lanes'
    rays gathered and walked by bucket) returns the hits of the launch in
    lane order bit for bit, and counts one launch and one ordered
    launch."""
    ktabs, o, d, active = _order_case(cuda, r, mask)
    box = _scene_box(cuda)
    want = t8.traverse8(*ktabs, o, d, active=active)
    before = (t8.traverse8.launches, t8.traverse8.ordered_launches)
    got = t8.traverse8(*ktabs, o, d, active=active, order_box=box)
    assert (t8.traverse8.launches, t8.traverse8.ordered_launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with pytest.raises(ValueError):
        t8.traverse8(*ktabs, o, d, active=active,
                     order_box=(box[0].double(), box[1]))


@pytest.mark.parametrize("leaf_size", [8, 4])
def test_megakernel_orders_bounce_launches(cuda, monkeypatch, leaf_size):
    """A 64x48, 4-spp, depth-8 megakernel frame of the sponza-like
    fixture: with traverse8's bounce launches ordered (every launch but
    each wave's first), the pixels and tallies equal those of the same
    frame with every launch in lane order, bit for bit. The Morton heap
    (traverse1) is never ordered."""
    host = load_glb(tproc.sponza_like_glb(scale=1))
    scene = build_device_scene(host, leaf_size=leaf_size, device=cuda)
    cam = make_camera(64, 48, host.camera_position, host.camera_direction,
                      host.camera_focal_length, device=cuda)
    kw = dict(width=64, height=48, spp=4, max_depth=8, seed=(1 << 40) + 3)
    before = (t8.traverse8.launches, t8.traverse8.ordered_launches,
              t1.traverse1.launches)
    img, rays = render_megakernel(scene, cam, **kw)
    after = (t8.traverse8.launches, t8.traverse8.ordered_launches,
             t1.traverse1.launches)
    launched = [a - b for a, b in zip(after, before)]
    bounces = int((rays > 0).sum())
    assert bounces >= 5
    if leaf_size == 8:
        assert launched == [bounces, bounces - 1, 0]
    else:
        assert launched == [0, 0, bounces]

    def lane_order(*args, order_box=None, **kwargs):
        return t8.traverse8(*args, **kwargs)

    monkeypatch.setattr(ttrace, "traverse8", lane_order)
    img_l, rays_l = render_megakernel(scene, cam, **kw)
    assert torch.equal(rays, rays_l)
    assert torch.equal(img.view(torch.int32), img_l.view(torch.int32))


@pytest.mark.parametrize("name", _KERNELS)
def test_wrapper_refuses_misaligned_tables(cuda, name):
    """A table view that starts 4 bytes past a 16-byte boundary is
    refused: the kernels read tables with 16-byte loads (traverse5's
    leaf_slot, read one value at a time, is not checked)."""
    cam, pts, ktabs, _, kern, _, kw = _kernel_case(name, cuda)
    o, d = _case_rays(cam, pts, 64, 1, cuda)

    def misaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    for i, t in enumerate(ktabs):
        if not isinstance(t, torch.Tensor):
            continue
        bad = list(ktabs)
        bad[i] = misaligned(t)
        with pytest.raises(ValueError, match="16-byte"):
            kern(*bad, o, d, **kw)
    if "leaf_xf" in kw:
        with pytest.raises(ValueError, match="16-byte"):
            kern(*ktabs, o, d, leaf_slot=kw["leaf_slot"],
                 leaf_xf=misaligned(kw["leaf_xf"]))


_STAGE_SCENE = {}


def _stage_lanes(dev, r, done=None, seed=21):
    """r lanes of a megakernel state on sponza scale 1 (textured diffuse,
    metal, glass and emissive materials; SAH tree, int64 ids): rays half
    from the camera and half from points in the scene, their hits through
    intersect_scene with the done lanes inactive, and attenuation,
    radiance, result and RNG keys drawn at random."""
    if not _STAGE_SCENE:
        host = load_glb(tproc.sponza_like_glb(scale=1))
        _STAGE_SCENE.update(scene=build_device_scene(host, device=dev),
                            cam=host.camera_position,
                            pts=host.tri_v.reshape(-1, 3))
    scene = _STAGE_SCENE["scene"]
    o, d = _case_rays(_STAGE_SCENE["cam"], _STAGE_SCENE["pts"], r, seed, dev)
    if done is None:
        done = torch.zeros(r, dtype=torch.bool, device=dev)
    hit = ttrace.intersect_scene(scene, o, d, active=~done)
    gen = torch.Generator().manual_seed(seed)

    def draw(lo, hi):
        return V3(*(torch.empty(r).uniform_(lo, hi, generator=gen).to(dev)
                    for _ in range(3)))

    st = ttrace.PathState(o=o, d=d, att=draw(0.05, 1.0), rad=draw(0.0, 0.3),
                          result=draw(0.0, 0.5), done=done)
    key = torch.randint(0, 2**32, (r,), generator=gen,
                        dtype=torch.int64).to(dev)
    return scene, st, hit, key


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit as values (NaN equal to NaN)."""
    return a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


_LANES = [0, 1, 31, 33, 1 << 20]


@pytest.mark.parametrize("r", _LANES)
def test_shade_kernel_matches_plain(cuda, r):
    """The shading records of the hit lanes equal shade_lanes' normal,
    texture-applied albedo, emission, type, roughness and IOR bit for
    bit (both call rsqrtf)."""
    scene, _, hit, _ = _stage_lanes(cuda, r)
    before = vertex.shade.launches
    rec = vertex.shade(scene, hit)
    assert vertex.shade.launches == before + 1
    normal, uu, vv, mat = ttrace.shade_lanes(scene, hit)
    ref = torch.stack([*normal, *tmats.albedo_lanes(scene, mat, uu, vv),
                       *mat.emissive, mat.mtype.float(), mat.rough, mat.ior])
    ok = hit.tri >= 0
    assert _same(rec[:, ok], ref[:, ok])
    if r == 1 << 20:
        assert set(rec[9, ok].unique().tolist()) == {0.0, 1.0, 2.0}


def _hold_paths(dev, r, done=None, rr=False):
    """step_by_hand (shade and scatter kernels, state in place) against
    step_plain on the same hits: every column and the done flags equal
    bit for bit."""
    scene, st, hit, key = _stage_lanes(dev, r, done)
    miss = hit.tri < 0
    plain = ttrace.step_plain(scene, st, hit, miss, key, 6, rr)
    mine = ttrace.PathState(*(V3(*(c.clone() for c in v)) for v in st[:5]),
                            done=st.done.clone())
    before = (vertex.shade.launches, vertex.scatter.launches)
    assert ttrace.step_by_hand(scene, mine, hit, miss, key, 6, rr) is mine
    assert (vertex.shade.launches, vertex.scatter.launches) == (
        before[0] + 1, before[1] + 1)
    for name, a, b in zip(plain._fields, plain[:5], mine[:5]):
        for ca, cb in zip(a, b):
            assert _same(ca, cb), name
    assert torch.equal(plain.done, mine.done)
    return st, mine


@pytest.mark.parametrize("rr", [False, True])
@pytest.mark.parametrize("r", _LANES)
def test_scatter_paths_matches_plain_at_lane_counts(cuda, r, rr):
    st, mine = _hold_paths(cuda, r, rr=rr)
    if r == 1 << 20:
        assert 0 < int(mine.done.sum()) < r


@pytest.mark.parametrize("mask", ["sparse", "last_of_warp"])
def test_scatter_paths_matches_plain_under_done_masks(cuda, mask):
    """5 % of the lanes live at random, and only the last lane of each
    warp live: the done lanes keep their state."""
    r = 65536
    lane = torch.arange(r, device=cuda)
    gen = torch.Generator(device="cpu").manual_seed(19)
    live = {"sparse": (torch.rand(r, generator=gen) < 0.05).to(cuda),
            "last_of_warp": lane % 32 == 31}[mask]
    st, mine = _hold_paths(cuda, r, done=~live, rr=True)
    for a, b in zip(st[:5], mine[:5]):
        for ca, cb in zip(a, b):
            assert torch.equal(ca[~live], cb[~live])


@pytest.mark.parametrize("rr", [False, True])
@pytest.mark.parametrize("r", _LANES)
def test_scatter_queue_matches_plain(cuda, r, rr):
    """The wavefront's stages by hand against plain on one queue of r
    rays, one ray a pixel (so the pixel sums take no order): terminated
    flags, the survivors' direction, attenuation and radiance, and the
    pixel sums equal bit for bit; the key of each ray is drawn in the
    kernel from a seed above 32 bits."""
    scene, st, hit, _ = _stage_lanes(cuda, r)
    q = torch.stack([*st.o, *st.d, *st.att, *st.rad])
    q_id = torch.arange(r, device=cuda)
    lane = q_id * 3 + 1
    miss = hit.tri < 0
    out = []
    for stages in (twf._stages_plain, twf._stages_by_hand):
        acc = torch.zeros((r, 3), device=cuda)
        nd, na, rh, term = stages(scene, q, q_id, hit, miss, 4, acc,
                                  (1 << 40) + 7, 5, lane, rr)
        out.append((torch.stack([*nd, *na, *rh]), term, acc))
    (a, ta, acc_a), (b, tb, acc_b) = out
    assert torch.equal(ta, tb)
    assert _same(a[:, ~ta], b[:, ~ta])
    assert _same(acc_a, acc_b)
    if r == 1 << 20:
        assert 0 < int(ta.sum()) < r


@pytest.mark.parametrize("engine", ["wavefront", "megakernel"])
def test_stage_launches_equal_bounces(cuda, engine):
    """A frame launches the shade and the scatter kernel once per bounce
    of each wave (here one wave)."""
    host = load_glb(tfix.cube_scene_glb())
    scene = build_device_scene(host, device=cuda)
    cam = make_camera(48, 48, host.camera_position, host.camera_direction,
                      host.camera_focal_length, device=cuda)
    render = render_wavefront if engine == "wavefront" else render_megakernel
    before = (vertex.shade.launches, vertex.scatter.launches)
    _, rays = render(scene, cam, width=48, height=48, spp=2, max_depth=6,
                     seed=4)
    bounces = int((rays > 0).sum())
    assert bounces >= 3
    assert (vertex.shade.launches - before[0],
            vertex.scatter.launches - before[1]) == (bounces, bounces)


def test_stage_wrappers_refuse_bad_inputs(cuda):
    scene, st, hit, key = _stage_lanes(cuda, 64)
    miss = hit.tri < 0
    for bad in (hit._replace(u=hit.u.double()),
                hit._replace(tri=hit.tri.float()),
                hit._replace(v=hit.v[:-1]),
                hit._replace(t=hit.t.cpu())):
        with pytest.raises(ValueError):
            vertex.shade(scene, bad)
    tbl = scene.shade_tbl
    buf = torch.empty(tbl.numel() + 1, dtype=tbl.dtype, device=cuda)
    view = buf[1:].view(tbl.shape)
    view.copy_(tbl)
    with pytest.raises(ValueError, match="16-byte"):
        vertex.shade(dataclasses.replace(scene, shade_tbl=view), hit)
    rec = vertex.shade(scene, hit)
    path = dict(state=st, key=key)
    for args, kw in (((rec[:, :-1], hit.t, miss), path),
                     ((rec, hit.t, miss.to(torch.uint8)), path),
                     ((rec, hit.t.double(), miss), path),
                     ((rec, hit.t, miss), dict(state=st, key=key.int())),
                     ((rec, hit.t, miss), {}),
                     ((rec, hit.t, miss), dict(q=torch.zeros(
                         (12, 64), device=cuda), q_id=key, lane=key[:0])),
                     ((rec.cpu(), hit.t, miss), path)):
        with pytest.raises(ValueError):
            vertex.scatter(scene, *args, 2, **kw)
    with pytest.raises(ValueError, match="overlap"):
        vertex.scatter(scene, rec, hit.t, miss, 2,
                       state=st._replace(rad=st.att), key=key)


_PLAIN_COMPACT = twf._compact_plain
_BY_HAND_COMPACT = twf._compact_by_hand


def _compact_launches():
    return (compact.keys.launches, compact.sort.launches,
            compact.gather.launches)


def _hold_compaction(scene, q, q_id, lanes):
    """The compaction by hand (key pass, sort, gather) against the plain
    one on the card, on the lanes [t, new_dir, new_att, rad_hit,
    terminated] of a bounce: the next queue and its ids equal bit for
    bit, and the by-hand path empties the list. Returns the next queue
    by hand."""
    plain = _PLAIN_COMPACT(scene, q, q_id, lanes)
    before = _compact_launches()
    mine = _BY_HAND_COMPACT(scene, q, q_id, lanes)
    assert lanes == []
    assert _compact_launches() == tuple(b + 1 for b in before)
    assert torch.equal(mine[0].view(torch.int32), plain[0].view(torch.int32))
    assert torch.equal(mine[1], plain[1])
    return mine


_COMPACT_LANES = [0, 1, 31, 255, 256, 257, 1 << 20]


@pytest.mark.parametrize("r", _COMPACT_LANES)
@pytest.mark.parametrize("dead", ["some", "all"])
def test_compaction_matches_plain_at_lane_counts(cuda, r, dead):
    """One bounce of r lanes on sponza scale 1 (half camera rays, half
    from points in the scene) through the plain stages, at lane counts
    around a block's 256 threads, then compacted both ways; with every
    lane terminated the next queue is empty."""
    scene, st, hit, _ = _stage_lanes(cuda, r)
    q = torch.stack([*st.o, *st.d, *st.att, *st.rad])
    q_id = torch.arange(r, device=cuda) * 3 + 2
    acc = torch.zeros((max(r, 1), 3), device=cuda)
    nd, na, rh, term = twf._stages_plain(
        scene, q, q_id, hit, hit.tri < 0, 1, acc, 11, 0,
        torch.arange(max(r, 1), device=cuda), False)
    if dead == "all":
        term = torch.ones_like(term)
    q2, q_id2 = _hold_compaction(scene, q, q_id, [hit.t, nd, na, rh, term])
    assert q_id2.numel() == int((~term).sum())
    if r == 1 << 20 and dead == "some":
        assert 0 < q_id2.numel() < r


def _compaction_scenes(dev):
    """(scene, camera) of sponza scale 1 and of tests/test_torch_voxels.py's
    voxel world on `dev`, 64x48."""
    from srt_bench.scenes import voxels
    from sycl_ray_tracer_torch.utils.cli import load_scene

    out = {}
    for name, glb, two_level in (
            ("sponza", tproc.sponza_like_glb(scale=1), False),
            ("voxels", voxels.voxel_world_glb(
                n=32, seed=3, water_level=5, pitch=0.6, height=4.0), True)):
        scene, host = load_scene(glb, dev, two_level, log=lambda *a: None)
        out[name] = scene, make_camera(
            64, 48, host.camera_position, host.camera_direction,
            host.camera_focal_length, device=dev)
    return out


def test_compaction_matches_plain_on_frame_bounces(cuda, monkeypatch):
    """Every bounce of a 64x48, 4-spp, depth-10 frame of each scene: the
    compaction by hand gives the plain compaction's next queue bit for
    bit, and the frame launches the key pass and the gather once per
    bounce run. The frame with the plain compaction has the same tallies
    exactly (the queues are the same), and its image agrees within 1e-5:
    the pixel sums are index_add_'s atomics, whose order varies from run
    to run."""
    for name, (scene, cam) in _compaction_scenes(cuda).items():
        calls = []

        def both(scene, q, q_id, lanes):
            calls.append(q.shape[1])
            return _hold_compaction(scene, q, q_id, lanes)

        monkeypatch.setattr(twf, "_compact_by_hand", both)
        kw = dict(width=64, height=48, spp=4, max_depth=10,
                  seed=(1 << 40) + 9)
        img, rays = render_wavefront(scene, cam, **kw)
        bounces = int((rays > 0).sum())
        assert calls == rays[:bounces].tolist(), name
        assert bounces >= 6
        monkeypatch.setattr(twf, "_compact_by_hand", _BY_HAND_COMPACT)
        before = _compact_launches()
        img_h, rays_h = render_wavefront(scene, cam, **kw)
        assert tuple(a - b for a, b in zip(_compact_launches(), before)) \
            == (bounces,) * 3
        monkeypatch.setattr(twf, "_compact_by_hand", _PLAIN_COMPACT)
        img_p, rays_p = render_wavefront(scene, cam, **kw)
        assert torch.equal(rays_h, rays_p) and torch.equal(rays_h, rays)
        assert float((img_h - img_p).abs().max()) <= 1e-5, name
        monkeypatch.undo()


def test_compaction_wrappers_refuse_bad_inputs(cuda):
    scene, st, hit, _ = _stage_lanes(cuda, 64)
    q = torch.stack([*st.o, *st.d, *st.att, *st.rad])
    term = hit.tri < 0
    q_id = torch.arange(64, device=cuda)
    args = (scene, q, q_id, hit.t, st.d, st.att, st.rad, term)
    for i, bad in ((1, q[:, :-1]), (1, q.double()), (2, q_id.int()),
                   (3, hit.t.cpu()), (4, V3(st.d.x[:-1], st.d.y, st.d.z)),
                   (7, term.to(torch.uint8))):
        with pytest.raises(ValueError):
            compact.keys(*(bad if k == i else a for k, a in enumerate(args)))
    key, rec, stats = compact.keys(*args)
    for bad in ((key.long(), stats), (key, stats[:-1]), (key.cpu(), stats)):
        with pytest.raises(ValueError):
            compact.sort(*bad)
    perm = torch.arange(64, dtype=torch.int32, device=cuda)
    for bad in ((rec[:, :-1], perm), (rec, perm.long()),
                (rec, torch.arange(65, dtype=torch.int32, device=cuda)),
                (rec.cpu(), perm)):
        with pytest.raises(ValueError):
            compact.gather(*bad)


def _digit_stats(key: torch.Tensor) -> torch.Tensor:
    """compact.keys' stats for keys [n] (unsigned words in int64): no
    live count, each 8-bit digit's counts."""
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=key.device)]
                     + [torch.bincount((key >> (8 * p)) & 255, minlength=256)
                        for p in range(4)])


# a radix sort tile is 4,096 keys
_SORT_SIZES = [1, 4095, 4096, 4097, 3 * 4096 + 5, (1 << 20) + 7]


@pytest.mark.parametrize("n", _SORT_SIZES)
@pytest.mark.parametrize("keys", ["random", "few", "equal", "dead"])
def test_radix_sort_matches_stable_argsort(cuda, n, keys):
    """The by-hand radix sort against torch's stable argsort of the same
    unsigned keys: random 32-bit words, 37 distinct values (long runs of
    ties, which must keep lane order), one value, and the dead sentinel
    on every lane, at sizes around the 4,096-key tile."""
    gen = torch.Generator().manual_seed(n)
    key = {"random": torch.randint(0, 2**32, (n,), generator=gen),
           "few": torch.randint(0, 37, (n,), generator=gen) * 0x5A5A5A5,
           "equal": torch.full((n,), 0x12345678),
           "dead": torch.full((n,), 0xFFFFFFFF)}[keys].to(cuda)
    want = torch.argsort(key, stable=True)
    before = compact.sort.launches
    perm = compact.sort(key.to(torch.int32),
                        _digit_stats(key))
    assert compact.sort.launches == before + 1
    assert perm.dtype == torch.int32 and torch.equal(perm.long(), want)


def test_lbvh_walk_cuda_matches_cpu(cuda):
    """The binary-LBVH walk (plain torch) gives the same hits bit for bit
    on the card as on the cpu, and an LBVH render launches no kernel."""
    from sycl_ray_tracer_torch.ops.traverse import traverse

    host = load_glb(tproc.sponza_like_glb(scale=1))
    scenes = {dev: build_device_scene(host, device=dev, intersector="lbvh")
              for dev in (cuda, torch.device("cpu"))}
    o, d = _rays(host, 4096, 3, torch.device("cpu"))
    hits = {}
    for dev, s in scenes.items():
        tabs = (s.lbvh_lo, s.lbvh_hi, s.lbvh_v0, s.lbvh_e1, s.lbvh_e2)
        hits[dev.type] = traverse(*tabs, V3(*(c.to(dev) for c in o)),
                                  V3(*(c.to(dev) for c in d)), s.leaf_size)
    for a, b in zip(hits["cuda"], hits["cpu"]):
        assert torch.equal(a.cpu(), b)
    cam = make_camera(32, 24, host.camera_position, host.camera_direction,
                      host.camera_focal_length, device=cuda)
    before = (t8.traverse8.launches, t1.traverse1.launches,
              t5.traverse5.launches)
    img, _ = render_wavefront(scenes[cuda], cam, width=32, height=24, spp=2,
                              max_depth=3)
    assert bool(torch.isfinite(img).all())
    assert (t8.traverse8.launches, t1.traverse1.launches,
            t5.traverse5.launches) == before


def test_deep_tree_kernel_matches_plain(cuda):
    """sponza_like_glb(scale=3) (SAH depth 10, up to 71 stack entries):
    traverse8 equals its plain version outside 1e-6-relative t ties."""
    host = load_glb(tproc.sponza_like_glb(scale=3))
    scene = build_device_scene(host, device=cuda)
    assert scene.bvh_depth >= 10
    tabs = (scene.bvh_nodes, scene.bvh_child_ids, scene.bvh_woop,
            scene.sah_ni)
    o, d = _rays(host, 8192, 4, cuda)
    k = t8.traverse8(*tabs, o, d)
    p = t8.traverse8_plain(*tabs, o, d)
    assert torch.equal(k.tri >= 0, p.tri >= 0)
    tie = (k.t - p.t).abs() <= 1e-6 * p.t.abs()
    assert not bool(((k.tri != p.tri) & ~tie).any())


@pytest.mark.parametrize("name", ["traverse8", "traverse5"])
def test_sbvh_kernels_match_plain_and_brute(cuda, name):
    """On the straddler scene's SBVH tree (spatial splits duplicated
    references), traverse8 and traverse5 in MT mode equal their plain
    versions outside 1e-6-relative t ties, and their ids after the SAH
    order equal the brute-force ids exactly."""
    from sycl_ray_tracer_torch.ops import woop
    from sycl_ray_tracer_torch.ops.intersect import intersect_brute_np

    tri, o_np, d_np = tfix.straddler_scene(rays=4096)
    b = tsah.build_sah(tri, 8, spatial=True)
    assert b.num_refs > tri.shape[0]
    rows = tsah.leaf_rows(tri, b.order, 8)
    if name == "traverse8":
        m, tr, _ = woop.woop_from_leaf_rows(rows, 8)
        leaves = np.concatenate([m.reshape(-1, 9), tr.reshape(-1, 3)], 1)
        kern, plain = t8.traverse8, t8.traverse8_plain
    else:
        leaves = tsah.slot_rows(rows, 8)
        kern, plain = t5.traverse5, t5.traverse5_plain
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    v3 = lambda a: V3(*(dev(a[:, i]) for i in range(3)))
    args = (dev(b.children), dev(b.child_ids), dev(leaves), b.num_internal,
            v3(o_np), v3(d_np))
    k, p = kern(*args), plain(*args)
    assert torch.equal(k.tri >= 0, p.tri >= 0)
    tie = (k.t - p.t).abs() <= 1e-6 * p.t.abs()
    assert not bool(((k.tri != p.tri) & ~tie).any())
    slot = k.tri.cpu().numpy()
    got = np.where(slot >= 0, b.order[np.maximum(slot, 0)], -1)
    assert np.array_equal(got, intersect_brute_np(o_np, d_np, tri)[1])


def test_resized_textures_without_pil_match_pinned_digests(cuda):
    """On this machine, with every import of PIL refused: the resized
    fixture textures equal the digests pinned against Pillow on the CPU
    (tests/test_torch_ingest.py::test_resized_textures_pinned)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import sys, hashlib
class _NoPil:
    def find_spec(self, name, path=None, target=None):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL refused")
sys.meta_path.insert(0, _NoPil())
from sycl_ray_tracer_torch.utils import fixtures
from sycl_ray_tracer_torch.utils.gltf import load_glb
tex = load_glb(fixtures.resized_textures_glb()).textures
got = tuple(hashlib.sha256(t.tobytes()).hexdigest() for t in tex)
assert got == fixtures.RESIZED_TEXTURES_SHA256, got
assert "PIL" not in sys.modules
print("ok")
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "ok"


def test_two_gloo_ranks_on_one_card_match_single(cuda, tmp_path):
    """parallel/mesh.py with two gloo ranks sharing the card (NCCL
    refuses two ranks on one GPU): meshes 2x1 and 1x2 on the cube equal
    the single-device render to 1e-6 RMSE with equal tallies, and each
    rank launched traverse8 once per bounce of each of its waves."""
    from chip_smoke import check_rank_launches, render_jobs
    from sycl_ray_tracer_torch.parallel.mesh import spawn

    kw = dict(width=48, height=48, spp=4, max_depth=6, seed=4)
    jobs = [dict(scene=0, dp=dp, sp=sp, renderer=r, **kw)
            for dp, sp in ((2, 1), (1, 2))
            for r in ("wavefront", "megakernel")]
    path = str(tmp_path / "out.pt")
    dev = f"cuda:{torch.cuda.current_device()}"
    spawn(render_jobs, 2, "gloo", [dev] * 2,
          f"file://{tmp_path / 'store'}", args=([dict(glb="cube")], jobs,
                                                path))
    host = load_glb(tfix.cube_scene_glb())
    scene = build_device_scene(host, device=cuda)
    cam = make_camera(48, 48, host.camera_position, host.camera_direction,
                      host.camera_focal_length, device=cuda)
    for job, (img, rays, _, launches) in zip(jobs, torch.load(path)):
        render = (render_wavefront if job["renderer"] == "wavefront"
                  else render_megakernel)
        ref, ref_rays = render(scene, cam, **kw)
        err = float(torch.sqrt(torch.mean(
            (img.double() - ref.cpu().double()) ** 2)))
        assert err < 1e-6, (job, err)
        assert torch.equal(rays, ref_rays), (job, rays, ref_rays)
        check_rank_launches(str(job), "traverse8", job, rays, launches)


def test_sweep_and_trace_on_card(cuda, tmp_path, monkeypatch):
    """benchmark_torch.py --inproc on the card at a tiny size (each
    run's total that of a render of its seed), and the CLI's
    traced_frame: the trace holds one traverse8 launch per bounce with
    device time, and the busy share lies in (0, 1]."""
    import csv

    from benchmark_torch import main as sweep
    from sycl_ray_tracer_torch.utils.cli import traced_frame

    kw = dict(width=64, height=48, spp=2, max_depth=4)
    monkeypatch.chdir(tmp_path)
    sweep(["--inproc", "--scenes", "cube", "--pairs", "4:2",
           "--resolutions", "64x48", "--runs", "1", "--renderers",
           "wavefront", "megakernel"])
    with open(tmp_path / "benchmark_torch_raw.csv", newline="") as f:
        raw = list(csv.reader(f))[1:]
    host = load_glb(tfix.cube_scene_glb())
    scene = build_device_scene(host, device=cuda)
    cam = make_camera(64, 48, host.camera_position, host.camera_direction,
                      host.camera_focal_length, device=cuda)
    want = [int(render_wavefront(scene, cam, seed=r, **kw)[1].sum())
            for r in range(2)]
    assert [int(r[8]) for r in raw] == want * 2
    (_, rays), secs, st = traced_frame(
        lambda: render_wavefront(scene, cam, seed=0, **kw), cuda,
        str(tmp_path / "trace"))
    ran = [k for k in st["kernels"] if "traverse8_kernel" in k[0]]
    assert sum(k[2] for k in ran) == int((rays > 0).sum())
    assert sum(k[1] for k in ran) > 0 and 0 < st["busy"] <= 1.0
    assert (tmp_path / "trace" / "trace_rank0.json").stat().st_size > 0
    # a wave's 3 waits, and 2 in each bounce (utils/profile.py:sync): the
    # terminated rays' index list and the live count; the scatter kernel
    # takes its RNG counters as arguments
    assert sum(st["syncs"].values()) == 3 + 2 * int((rays > 0).sum())


_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
               "cudaMemset")


@pytest.mark.parametrize("engine", ["wavefront", "megakernel"])
def test_every_wait_of_a_frame_is_a_sync_range(cuda, engine, monkeypatch):
    """One small frame of each engine: every synchronizing CUDA call
    lies inside a utils/profile.py:sync range. Under
    torch.cuda.set_sync_debug_mode("warn") each warning comes while a
    sync range is open, and in the profiler's trace every synchronizing
    runtime call starts inside a srt.sync.* host range."""
    import contextlib
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from sycl_ray_tracer_torch.utils import profile as sprofile

    render = render_wavefront if engine == "wavefront" else render_megakernel
    host = load_glb(tproc.sponza_like_glb(scale=1))
    scene = build_device_scene(host, device=cuda)
    cam = make_camera(64, 48, host.camera_position, host.camera_direction,
                      host.camera_focal_length, device=cuda)
    kw = dict(width=64, height=48, spp=4, max_depth=6, seed=7)
    ref, ref_rays = render(scene, cam, **kw)  # builds the kernels
    torch.cuda.synchronize()

    depth, seen = [0], []
    real = sprofile.sync

    @contextlib.contextmanager
    def counted(name):
        with real(name):
            depth[0] += 1
            try:
                yield
            finally:
                depth[0] -= 1

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            seen.append((str(message), depth[0]))

    monkeypatch.setattr(sprofile, "sync", counted)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            img, rays = render(scene, cam, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    outside = [m for m, d in seen if d == 0]
    print(f"{engine}: {len(seen)} sync warnings, {len(outside)} outside "
          "a sync range")
    assert seen and not outside, outside[:3]

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("test.frame"):
            img2, rays2 = render(scene, cam, **kw)
    ranges, calls, frame = [], [], None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            continue
        span = (e.start_ns(), e.end_ns())
        if e.name() == "test.frame":
            frame = span
        elif e.name().startswith("srt.sync."):
            ranges.append(span)
        elif e.name() in _SYNC_CALLS:
            calls.append(span)
    calls = [c for c in calls if frame[0] <= c[0] < frame[1]]
    free = [c for c in calls
            if not any(s <= c[0] and c[1] <= e for s, e in ranges)]
    print(f"{engine}: {len(ranges)} srt.sync ranges, {len(calls)} "
          f"synchronizing runtime calls, {len(free)} outside them")
    assert calls and not free
    for a, b in ((ref, img), (ref, img2)):
        assert float(torch.sqrt(torch.mean(
            (a.double() - b.double()) ** 2))) < 1e-6
    assert torch.equal(rays, ref_rays) and torch.equal(rays2, ref_rays)
