"""Port intersectors (ops/traverse8.py, ops/traverse5.py): the plain
torch versions against the JAX package's Woop reference and CPU
traversal, and the kernels' own per-ray walk (csrc/walk_regs.cuh with
the leaf tests of traverse8.cuh and traverse5.cuh, built here with g++)
against the plain versions, with each kernel's walk pinned to its work
on fixed rays."""

import shutil

import numpy as np
import pytest
import torch

from sycl_ray_tracer_tpu.ops import woop as jwoop
from sycl_ray_tracer_torch.models import trace as ttrace
from sycl_ray_tracer_torch.models.camera import make_camera
from sycl_ray_tracer_torch.models.instanced import (
    build_instanced_device_scene)
from sycl_ray_tracer_torch.ops import kernels
from sycl_ray_tracer_torch.ops import sah as tsah
from sycl_ray_tracer_torch.ops import traverse5 as t5
from sycl_ray_tracer_torch.ops import traverse8 as t8
from sycl_ray_tracer_torch.ops.vec import V3
from sycl_ray_tracer_torch.utils.instanced import load_glb_instanced
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils import procgen as tproc

from tests.torch_common import (host_vs_plain, lane_mask, pinned_rays,
                                port_pair, tv3)

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
    from sycl_ray_tracer_torch.models.wavefront import (_gen_queue,
                                                        frame_pixels)
    q, _ = _gen_queue(cam, 0, 0, pixels=frame_pixels(64, 32, "cpu"))
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
    kernels.load_host_library()


def _host_traverse(scene, o, d, active=None, t_init=None):
    return kernels.run_host(
        "traverse8", [scene.bvh_nodes, scene.bvh_child_ids, scene.bvh_woop,
                      scene.sah_ni], tv3(o), tv3(d), active, t_init)


@pytest.mark.parametrize("name,r", [("cube", 1024), ("sponza", 4096)])
def test_kernel_walk_host_build_matches_plain(name, r):
    """The per-ray walk the CUDA kernel runs, compiled for the CPU: tri
    ids equal outside 1e-6-relative t ties, t rtol 1e-4, u/v atol 1e-4,
    plus the t_init and inactive-lane semantics."""
    _host_lib()
    host, scene, _ = _pair(name)
    o, d = _rays(host, r, 11)
    t, tri, u, v = _host_traverse(scene, o, d)
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

    _, tri2, _, _ = _host_traverse(scene, o, d, t_init=t)
    assert (tri2 == -1).all()
    active = torch.from_numpy(np.random.RandomState(2).rand(r) < 0.5)
    t3, tri3, u3, v3 = _host_traverse(scene, o, d, active=active)
    ina = ~active
    assert (t3[ina] == 0).all() and (tri3[ina] == -1).all()
    assert (u3[ina] == 0).all() and (v3[ina] == 0).all()
    assert (tri3[active] == tri[active]).all()
    assert (t3[active] == t[active]).all()


# Work of traverse8's walk on the pinned rays of sponza_proc scale 1
# (tests/torch_common.py:pinned_rays): [child boxes slab-tested, leaves
# tested], counted by the host build of the walk as it stood before
# the kernel's redesign. The redesign keeps the order of the walk, so it
# visits the same nodes and tests the same leaves. The tie rule
# (csrc/bvh8_walk.cuh) also enters the boxes whose entry distance equals
# t_best: [69021, 2739] and [61389, 2231] before it.
_PINNED8 = {"primary": [69089, 2750], "bounce": [61389, 2233]}
_FRAME = {}


def _frame():
    """(tables of traverse8, {primary, bounce: [6, 2048]}) on sponza
    scale 1 at a 64x32 camera."""
    if not _FRAME:
        host, scene, _ = _pair("sponza")
        cam = make_camera(64, 32, host.camera_position,
                          host.camera_direction, host.camera_focal_length,
                          device="cpu")
        _FRAME.update(tables=[scene.bvh_nodes, scene.bvh_child_ids,
                              scene.bvh_woop, scene.sah_ni],
                      rays=pinned_rays(scene, cam))
    return _FRAME["tables"], _FRAME["rays"]


@pytest.mark.parametrize("which", ["primary", "bounce"])
def test_kernel_walk_pinned_counts(which):
    _host_lib()
    tables, rays = _frame()
    q = rays[which]
    counts = torch.zeros(2, dtype=torch.int64)
    kernels.run_host("traverse8", tables, V3(*q[:3]), V3(*q[3:]),
                     counts=counts)
    assert counts.tolist() == _PINNED8[which]


def _walk_case(kernel):
    """(host-build name, its tables, pinned rays, plain(o, d, **kw)) of
    one kernel: "traverse8" on sponza scale 1, "traverse5-mt" on the
    baked SAH tree of the same scene (the same rays), "traverse5-itf" on
    the instanced fixture with the pinned rays of its own camera."""
    if kernel == "traverse8":
        tables, rays = _frame()
        return ("traverse8", tables, rays,
                lambda o, d, **kw: t8.traverse8_plain(*tables, o, d, **kw))
    mode = kernel.split("-")[1]
    tables, _ = _mt_tables(mode)
    nodes, ids, mt, slot, xf, ni = tables
    rays = _frame()[1] if mode == "mt" else _itf_rays()
    return ("traverse5", tables, rays,
            lambda o, d, **kw: t5.traverse5_plain(
                nodes, ids, mt, ni, o, d, leaf_slot=slot, leaf_xf=xf, **kw))


_MASK_CASES = [(k, m) for k in ("traverse8", "traverse5-mt", "traverse5-itf")
               for m in ("none", "one", "sparse", "all")]


@pytest.mark.parametrize(
    "kernel,mask", _MASK_CASES,
    ids=[m if k == "traverse8" else f"{k}-{m}" for k, m in _MASK_CASES])
def test_kernel_walk_matches_plain_under_masks(kernel, mask):
    """The host build of a kernel's walk against its plain version on
    the pinned primary and bounce rays under each mask: equal bit for
    bit where the ids agree, ids equal outside equal-t ties."""
    _host_lib()
    name, tables, rays, plain_fn = _walk_case(kernel)
    for q in rays.values():
        o, d = V3(*q[:3]), V3(*q[3:])
        active = lane_mask(mask, q.shape[1], 31)
        host = kernels.run_host(name, tables, o, d, active=active)
        plain = plain_fn(o, d, active=active)
        host_vs_plain(host, plain)
        assert int((host.tri >= 0).sum()) <= int(active.sum())
        assert (host.t[~active] == 0).all()


@pytest.mark.parametrize("kernel",
                         ["traverse8", "traverse5-mt", "traverse5-itf"])
def test_kernel_walk_t_init_chaining(kernel):
    """t_init on the host build as on plain: a seeded mix of incumbents
    below and above the closest hit gives equal results, and chaining
    on the found t finds nothing closer."""
    _host_lib()
    name, tables, rays, plain_fn = _walk_case(kernel)
    q = rays["bounce"]
    o, d = V3(*q[:3]), V3(*q[3:])
    first = plain_fn(o, d)
    scale = torch.from_numpy(
        np.random.RandomState(32).uniform(0.5, 1.5, q.shape[1])
        .astype(np.float32))
    t_init = torch.where(first.tri >= 0, first.t * scale,
                         torch.full_like(first.t, 50.0))
    host = kernels.run_host(name, tables, o, d, t_init=t_init)
    plain = plain_fn(o, d, t_init=t_init)
    host_vs_plain(host, plain)
    assert ((host.tri < 0) & (host.t != t_init)).sum() == 0
    assert 0 < int((host.tri >= 0).sum()) < int((first.tri >= 0).sum())
    again = kernels.run_host(name, tables, o, d, t_init=host.t)
    assert (again.tri == -1).all() and torch.equal(again.t, host.t)


def test_wrapper_rejects_non_cpu_non_cuda_and_checks_stack():
    host, scene, _ = _pair("cube")
    o, d = _rays(host, 8, 1)
    meta = [x.to("meta") for x in (scene.bvh_nodes, scene.bvh_child_ids,
                                   scene.bvh_woop)]
    with pytest.raises(ValueError):
        t8.traverse8(*meta, scene.sah_ni, tv3(o), tv3(d))


_T5 = {}


def _itf_scene():
    """(instanced host, its CPU DeviceScene) of the fixture (r = 30)."""
    if "itf" not in _T5:
        ih = load_glb_instanced(tfix.instanced_scene_glb(30))
        _T5["itf"] = ih, build_instanced_device_scene(ih, device="cpu")
    return _T5["itf"]


def _itf_rays():
    """The pinned rays (tests/torch_common.py) of the instanced fixture
    at a 64x32 camera."""
    if "itf_rays" not in _T5:
        ih, ts = _itf_scene()
        cam = make_camera(64, 32, ih.camera_position, ih.camera_direction,
                          ih.camera_focal_length, device="cpu")
        _T5["itf_rays"] = pinned_rays(ts, cam)
    return _T5["itf_rays"]


def _mt_tables(name):
    """(tables of traverse5 as a list, points spanning the scene): MT
    mode on the baked SAH tree of sponza scale 1 (rows from
    sah.leaf_rows), itf mode on the port's instanced fixture tables."""
    if name == "mt":
        host, scene, _ = _pair("sponza")
        if "mt" not in _T5:
            order = tsah.build_sah(host.tri_v, 8).order
            _T5["mt"] = torch.from_numpy(tsah.slot_rows(
                tsah.leaf_rows(host.tri_v, order, 8), 8))
        return [scene.bvh_nodes, scene.bvh_child_ids, _T5["mt"], None, None,
                scene.sah_ni], host.tri_v.reshape(-1, 3)
    ih, ts = _itf_scene()
    return [ts.bvh_nodes, ts.bvh_child_ids, ts.bvh_mt, ts.inst_leaf_slot,
            ts.inst_xf, ts.sah_ni], ih.inst_mat[:, :3, 3]


# Work of traverse5's walk on pinned rays (tests/torch_common.py:
# pinned_rays): [child boxes slab-tested, leaves tested] in MT mode on
# the baked SAH tree of sponza_proc scale 1 (the rays of _PINNED8) and in
# itf mode on the instanced fixture (r = 30), counted by the host build
# of the walk as it stood before the kernel's redesign, which keeps the
# order of the walk, and since the tie rule, which also enters the boxes
# at t_best (before it: [69021, 2741], [61365, 2221], [40295, 2505] and
# the same itf bounce count).
_PINNED5 = {("mt", "primary"): [69089, 2752],
            ("mt", "bounce"): [61381, 2231],
            ("itf", "primary"): [40295, 2513],
            ("itf", "bounce"): [46064, 3374]}


@pytest.mark.parametrize("mode,which", list(_PINNED5))
def test_traverse5_walk_pinned_counts(mode, which):
    _host_lib()
    name, tables, rays, _ = _walk_case(f"traverse5-{mode}")
    q = rays[which]
    counts = torch.zeros(2, dtype=torch.int64)
    kernels.run_host(name, tables, V3(*q[:3]), V3(*q[3:]), counts=counts)
    assert counts.tolist() == _PINNED5[(mode, which)]


@pytest.mark.parametrize("mode", ["mt", "itf"])
def test_traverse5_walk_host_build_matches_plain(mode):
    """The traverse5 kernel's per-ray walk, compiled for the CPU, against
    traverse5_plain in both modes: tri ids equal outside 1e-6-relative
    t ties, t rtol 1e-4, u/v atol 1e-4, t_init and inactive lanes."""
    _host_lib()
    tables, pts = _mt_tables(mode)
    nodes, ids, mt, slot, xf, ni = tables
    r = 4096
    rs = np.random.RandomState(21)
    o = rs.uniform(pts.min(0), pts.max(0), (r, 3)).astype(np.float32)
    d = rs.randn(r, 3).astype(np.float32)
    t, tri, u, v = kernels.run_host("traverse5", tables, tv3(o), tv3(d))
    p = t5.traverse5_plain(nodes, ids, mt, ni, tv3(o), tv3(d),
                           leaf_slot=slot, leaf_xf=xf)
    hit = p.tri >= 0
    assert ((tri >= 0) == hit).all()
    assert 0.2 < hit.float().mean() < 1.0
    tie = (t - p.t).abs() <= 1e-6 * p.t.abs()
    assert not (hit & (tri != p.tri) & ~tie).any()
    np.testing.assert_allclose(t.numpy(), p.t.numpy(), rtol=1e-4)
    same = (hit & (tri == p.tri)).numpy()
    np.testing.assert_allclose(u.numpy()[same], p.u.numpy()[same], atol=1e-4)
    np.testing.assert_allclose(v.numpy()[same], p.v.numpy()[same], atol=1e-4)
    assert (u[~hit] == 0).all() and (v[~hit] == 0).all()

    _, tri2, _, _ = kernels.run_host("traverse5", tables, tv3(o), tv3(d),
                                     t_init=t)
    assert (tri2 == -1).all()
    active = torch.from_numpy(rs.rand(r) < 0.5)
    t3, tri3, u3, v3 = kernels.run_host("traverse5", tables, tv3(o), tv3(d),
                                        active=active)
    ina = ~active
    assert (t3[ina] == 0).all() and (tri3[ina] == -1).all()
    assert (u3[ina] == 0).all() and (v3[ina] == 0).all()
    assert (tri3[active] == tri[active]).all()
    assert (t3[active] == t[active]).all()


@pytest.mark.parametrize("mode", ["mt", "itf"])
def test_traverse5_walk_host_build_counts_its_work(mode):
    """The host walk's counts (the work chip_smoke.py's bound counts): a
    ray leaving the scene tests the root's child boxes and no leaf, an
    inactive ray counts nothing, and counts add up over batches."""
    _host_lib()
    tables, pts = _mt_tables(mode)
    ids = tables[1]
    r = 512
    rs = np.random.RandomState(5)
    o = rs.uniform(pts.min(0), pts.max(0), (r, 3)).astype(np.float32)
    d = rs.randn(r, 3).astype(np.float32)

    def counts(o, d, active=None):
        c = torch.zeros(2, dtype=torch.int64)
        hit = kernels.run_host("traverse5", tables, tv3(o), tv3(d),
                               active=active, counts=c)
        return c.tolist(), hit

    away = np.array([[1e6, 1e6, 1e6]], np.float32)
    assert counts(away, away)[0] == [int((ids[0] != 0).sum()), 0]
    assert counts(o, d, active=torch.zeros(r, dtype=torch.bool))[0] == [0, 0]
    (boxes, leaves), hit = counts(o, d)
    half = [counts(o[s], d[s])[0] for s in (slice(0, r // 2),
                                             slice(r // 2, r))]
    assert [boxes, leaves] == [a + b for a, b in zip(*half)]
    assert leaves >= int((hit.tri >= 0).sum()) and boxes > leaves


def test_traverse5_wrapper_checks_inputs():
    tables, _ = _mt_tables("itf")
    nodes, ids, mt, slot, xf, ni = tables
    o = tv3(np.zeros((8, 3), np.float32))
    d = tv3(np.ones((8, 3), np.float32))
    with pytest.raises(ValueError, match="go together"):
        t5.traverse5(nodes, ids, mt, ni, o, d, leaf_slot=slot)
    meta = [x.to("meta") for x in (nodes, ids, mt)]
    with pytest.raises(ValueError):
        t5.traverse5(*meta, ni, o, d)
    # a CPU tensor runs the plain version, and counts no launch
    before = t5.traverse5.launches
    hit = t5.traverse5(nodes, ids, mt, ni, o, d, leaf_slot=slot,
                       leaf_xf=xf)
    assert t5.traverse5.launches == before and hit.t.shape == (8,)


def test_alignment_check():
    """The kernels read tables with 16-byte loads: the wrappers refuse a
    table that starts off a 16-byte boundary (checked here on the CPU,
    where the wrappers themselves run the plain versions)."""
    base = torch.zeros(8 * 48 + 4)
    kernels.check_aligned("nodes", base)
    for off in (1, 2, 3):
        with pytest.raises(ValueError, match="16-byte"):
            kernels.check_aligned("nodes", base[off:off + 8 * 48].view(8, 48))
    kernels.check_aligned("nodes", base[4:4 + 8 * 48].view(8, 48))


@pytest.mark.parametrize("engine", ["wavefront", "megakernel"])
def test_walks_agree_on_voxel_bounces(monkeypatch, engine):
    """The kernels' walk (its g++ build) against traverse5_plain on the
    rays of every bounce of a frame of minecraft_like_glb(n=72), whose
    coincident water and stone blocks put two faces at a bit-equal t on
    many rays: t equal on every ray, and ids, u and v at ties too, since
    both keep the least (t, id) hit (csrc/bvh8_walk.cuh; the one case
    the rule leaves to the order may flip at most 1 in 10,000 hits of
    the frame).
    Without that rule the depth-first walk kept the stone where the
    plain walk kept the water, on 1,214 of 41,472 primary rays at 96x54
    and 8 spp."""
    from sycl_ray_tracer_torch.models.renderer import get_renderer

    _host_lib()
    ih = load_glb_instanced(tproc.minecraft_like_glb(n=72))
    scene = build_instanced_device_scene(ih, device="cpu")
    cam = make_camera(32, 18, ih.camera_position, ih.camera_direction,
                      ih.camera_focal_length, device="cpu")
    calls = []

    def both(nodes, child_ids, mt, ni, o, d, active=None, t_init=None,
             leaf_slot=None, leaf_xf=None):
        plain = t5.traverse5_plain(nodes, child_ids, mt, ni, o, d, active,
                                   t_init, leaf_slot, leaf_xf)
        calls.append((kernels.run_host(
            "traverse5", [nodes, child_ids, mt, leaf_slot, leaf_xf, ni], o,
            d, active, t_init), plain))
        return plain

    monkeypatch.setattr(ttrace, "traverse5", both)
    get_renderer(engine)(scene, cam, width=32, height=18, spp=8,
                         max_depth=10, seed=123456789)
    assert len(calls) == 10
    hits = flips = 0
    for host, plain in calls:
        assert torch.equal(host.t, plain.t)
        hits += int((plain.tri >= 0).sum())
        flips += int(((host.tri != plain.tri) | (host.u != plain.u)
                      | (host.v != plain.v)).sum())
    assert hits > 0 and flips <= hits // 10000, (hits, flips)
