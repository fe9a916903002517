"""The Morton-heap path of the port (ops/wbvh.py:build_np,
ops/traverse1.py, the heap branch of models/scene.py and
models/trace.py:intersect_scene) against the JAX package on the same
inputs: the tables, the plain version against interpret-mode
traverse_packets (v1) and brute force at K in {1, 4, 8}, against the
XLA heap walk the JAX package runs on the CPU, the g++ build of the
kernel's per-ray walk against the plain version (its work pinned on
fixed rays), and the dispatch against the SAH path of the same
scene."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sycl_ray_tracer_tpu.models.scene import build_device_scene as jbuild
from sycl_ray_tracer_tpu.ops import wbvh as jwbvh
from sycl_ray_tracer_tpu.ops.intersect import intersect_brute_np
from sycl_ray_tracer_tpu.utils.gltf import load_glb as jload
from sycl_ray_tracer_torch.models import trace as ttrace
from sycl_ray_tracer_torch.models.scene import build_device_scene, load_scene
from sycl_ray_tracer_torch.models.wavefront import (_bounce, _gen_queue,
                                                     frame_pixels)
from sycl_ray_tracer_torch.ops import kernels
from sycl_ray_tracer_torch.ops import sah as tsah
from sycl_ray_tracer_torch.ops import traverse1 as t1
from sycl_ray_tracer_torch.ops.traverse5 import traverse5_plain
from sycl_ray_tracer_torch.ops import wbvh as twbvh
from sycl_ray_tracer_torch.ops.vec import V3
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils import procgen as tproc

from tests.torch_common import (host_vs_plain, jv3, lane_mask, pinned_rays,
                                tv3)


def _random_tris(n, seed, spread=5.0):
    """test_pallas.py:33-53's scene: n small triangles around uniform
    centres."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return c[:, None, :] + rs.uniform(-0.3, 0.3, (n, 3, 3)).astype(
        np.float32)


def _tables(tri, k):
    b = twbvh.build_np(tri, k)
    return (torch.from_numpy(b.children), torch.from_numpy(b.leaves),
            b.num_internal, k), b


@pytest.mark.parametrize("k", [1, 4, 8])
def test_build_np_matches_jax(k):
    tri = _random_tris(1237, 3)
    j, _, _ = jwbvh.build_np(tri, k)
    t = twbvh.build_np(tri, k)
    assert (t.num_internal, t.depth, t.leaf_size) == (
        j.num_internal, j.depth, j.leaf_size)
    for f in ("children", "leaves", "order"):
        a, b = np.asarray(getattr(j, f)), getattr(t, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert (a == b).all(), f
    assert t.leaves.shape == (-(-1237 // k), 9 * k)
    assert (t.order == twbvh.morton_order(tri, k)).all()
    assert (twbvh.heap_child_ids_np(t.num_internal)
            == jwbvh.heap_child_ids_np(j.num_internal)).all()


def _v1_interpret(jb, o, d, active=None):
    """JAX traverse_packets (v1) on the JAX build's tables, with
    pallas_call in interpret mode (the patch of
    tests/test_pallas.py:15-30)."""
    import sycl_ray_tracer_tpu.ops.traverse_pallas as TP

    orig = TP.pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    TP.pl.pallas_call = patched
    try:
        return TP.traverse_packets(
            jnp.asarray(jb.children), jnp.asarray(jb.leaves),
            jb.num_internal, jb.depth, jb.leaf_size, jv3(o), jv3(d),
            active=None if active is None else jnp.asarray(active))
    finally:
        TP.pl.pallas_call = orig


@pytest.mark.parametrize("k", [1, 4, 8])
def test_plain_matches_traverse_packets_interpret_and_brute(k):
    """tri ids equal to interpret-mode v1 and to brute force, t within
    rtol 1e-5 / atol 1e-6 of both (the JAX test's tolerance), u/v within
    atol 1e-4 of v1's; misses report t = BIG on both."""
    tri = _random_tris(1500, 11)
    rs = np.random.RandomState(12)
    r = 2048
    o = rs.uniform(-8, 8, (r, 3)).astype(np.float32)
    d = rs.uniform(-1, 1, (r, 3)).astype(np.float32)
    jb, sorted_v, _ = jwbvh.build_np(tri, k)
    ref = _v1_interpret(jb, o, d)
    args, _ = _tables(tri, k)
    hit = t1.traverse1(*args, tv3(o), tv3(d))     # CPU tensors -> plain
    tri_p, t_p = hit.tri.numpy(), hit.t.numpy()
    rtri, rt = np.asarray(ref.tri), np.asarray(ref.t)
    t_b, id_b, _, _ = intersect_brute_np(o, d, np.asarray(sorted_v))
    both = id_b >= 0
    assert 0.05 < both.mean() < 0.95
    assert (tri_p == rtri).all() and (tri_p == id_b).all()
    np.testing.assert_allclose(t_p[both], rt[both], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_p[both], t_b[both], rtol=1e-5, atol=1e-6)
    for a, b in ((hit.u, ref.u), (hit.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both],
                                   atol=1e-4)
    assert (t_p[~both] == np.float32(3e38)).all()
    assert (rt[~both] == np.float32(3e38)).all()
    assert (hit.u.numpy()[~both] == 0).all()


def test_plain_active_mask_matches_traverse_packets_interpret():
    """test_pallas.py:140-157 at K=4: inactive lanes report tri = -1
    on both; the port reports t = 0 there (v1 writes -BIG; no caller
    reads it), and active lanes hit as v1's do."""
    rs = np.random.RandomState(13)
    tri = _random_tris(300, 14, spread=2.0)
    tri[0] = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    k = 4
    jb, _, _ = jwbvh.build_np(tri, k)
    r = 1024
    o = np.tile(np.float32([0, 0, 8]), (r, 1))
    d = np.tile(np.float32([0, 0, -1]), (r, 1))
    o[:, :2] += rs.uniform(-0.2, 0.2, (r, 2)).astype(np.float32)
    active = np.arange(r) % 2 == 0
    ref = _v1_interpret(jb, o, d, active)
    args, _ = _tables(tri, k)
    hit = t1.traverse1_plain(*args, tv3(o), tv3(d),
                             active=torch.from_numpy(active))
    tri_p, rtri = hit.tri.numpy(), np.asarray(ref.tri)
    assert (rtri[1::2] == -1).all() and (tri_p[1::2] == -1).all()
    assert (rtri[0::2] >= 0).all() and (tri_p == rtri).all()
    assert (hit.t.numpy()[1::2] == 0).all()
    assert (hit.u.numpy()[1::2] == 0).all() and (hit.v.numpy()[1::2] == 0).all()
    np.testing.assert_allclose(hit.t.numpy()[0::2], np.asarray(ref.t)[0::2],
                               rtol=1e-5, atol=1e-6)


def test_padding_leaves_are_skipped():
    """The heap's padding subtrees have the point box at (3e38, 3e38,
    3e38). A ray with equal direction components enters it (its three
    slab distances are equal); the port skips the leaf children past
    the table instead of testing a clamped row, and still agrees with
    brute force."""
    tri = _random_tris(70, 15, spread=1.0)   # 18 of 64 heap leaves real
    tri[0] = np.eye(3, dtype=np.float32) * 1.5   # across the diagonal
    k = 4
    args, b = _tables(tri, k)
    assert b.leaves.shape[0] < 8 ** b.depth
    o = np.float32([[0, 0, 0], [0.1, 0.1, 0.1], [-3, -3, -3], [3, 3, 3]])
    d = np.float32([[2, 2, 2], [0.5, 0.5, 0.5], [1, 1, 1], [-2, -2, -2]])
    hit = t1.traverse1_plain(*args, tv3(o), tv3(d))
    sv = tri[np.maximum(b.order, 0)]
    sv[b.order < 0] = 0.0
    _, id_b, _, _ = intersect_brute_np(o, d, sv)
    assert (hit.tri.numpy() == id_b).all() and (id_b >= 0).all()


_SPONZA = {}


def _sponza():
    """(port host, K=4 heap scene, K=8 SAH scene, camera) of the
    procedural Sponza at scale 1, on the cpu."""
    if not _SPONZA:
        scene, host, cam = tfix.load_pair(tproc.sponza_like_glb(scale=1),
                                          64, 32, leaf_size=4, device="cpu")
        _SPONZA.update(host=host, heap=scene, cam=cam,
                       sah=build_device_scene(host, device="cpu"))
    return _SPONZA


def _frame_rays(scene, cam):
    """The 2048 primary rays of a 64x32 frame and the first-bounce rays
    that survive them, from the port's wavefront on `scene`."""
    pixels = frame_pixels(64, 32, "cpu")
    q, q_id = _gen_queue(cam, 0, 0, pixels=pixels)
    prim = q[0:6].T.numpy().copy()
    acc = torch.zeros((64 * 32, 3))
    qb, _ = _bounce(scene, q, q_id, 0, acc, 0, 0, pixels[2])
    return prim, qb[0:6].T.numpy().copy()


def test_plain_matches_jax_cpu_heap_walk_on_sponza():
    """Against the path the JAX package takes for heap scenes on the CPU
    (the XLA walk wbvh.traverse8 over its unified table, octant order):
    equal Morton ids outside 1e-6-relative t ties, t rtol 1e-4, on
    primary and first-bounce rays."""
    from sycl_ray_tracer_tpu.ops.wbvh import traverse8 as jtraverse8

    s = _sponza()
    js = jbuild(jload(tproc.sponza_like_glb(scale=1)), leaf_size=4)
    assert js.bvh_ni == s["heap"].bvh_ni and js.bvh_depth == s["heap"].bvh_depth
    assert (np.asarray(js.shade_tbl) == s["heap"].shade_tbl.numpy()).all()
    for rays in _frame_rays(s["heap"], s["cam"]):
        o, d = rays[:, :3], rays[:, 3:]
        hit = ttrace.intersect_scene(s["heap"], tv3(o), tv3(d))
        jh = jtraverse8(js.bvh_nodes, js.bvh_ni, js.bvh_depth, 4, jv3(o),
                        jv3(d))
        tri, jtri = hit.tri.numpy(), np.asarray(jh.tri)
        t, jt = hit.t.numpy(), np.asarray(jh.t)
        assert ((tri >= 0) == (jtri >= 0)).all()
        both = tri >= 0
        assert both.mean() > 0.5
        tie = np.abs(t - jt) <= 1e-6 * np.abs(jt)
        assert not (both & (tri != jtri) & ~tie).any()
        # rtol 1e-4: XLA fuses multiply-adds that torch rounds twice,
        # which matters near TNEAR (t about 2e-4 on a bounce ray)
        np.testing.assert_allclose(t[both], jt[both], rtol=1e-4)


def test_dispatch_heap_and_sah_give_the_same_morton_ids():
    """intersect_scene on the K=4 heap scene (traverse1, MT leaves, no
    remap) and on the K=8 SAH scene of the same host (traverse8, Woop
    leaves, bvh_remap): the same canonical slots outside ties, where MT
    and Woop t may differ by 5e-4 relative, and apart from hits within
    1e-3 of the ray's origin (a bounce ray's own surface, which the two
    leaf tests place on either side of TNEAR); against traverse5 in MT
    mode on the SAH tree (the same arithmetic on the same rows), equal
    hits outside 1e-6-relative t ties; and the same shading rows for
    every triangle."""
    s = _sponza()
    heap, sah = s["heap"], s["sah"]
    assert heap.has_heap and not sah.has_heap and heap.leaf_size == 4
    n = heap.num_triangles
    assert (heap.shade_tbl[:n] == sah.shade_tbl[:n]).all()
    mt = torch.from_numpy(tsah.slot_rows(tsah.leaf_rows(
        s["host"].tri_v, tsah.build_sah(s["host"].tri_v, 8).order, 8), 8))
    for rays in _frame_rays(heap, s["cam"]):
        o, d = tv3(rays[:, :3]), tv3(rays[:, 3:])
        a = ttrace.intersect_scene(heap, o, d)
        c = traverse5_plain(sah.bvh_nodes, sah.bvh_child_ids, mt, sah.sah_ni,
                            o, d)
        tri_c = torch.where(c.tri >= 0, sah.bvh_remap[c.tri.clamp(min=0)],
                            -1)
        hit = a.tri >= 0
        assert torch.equal(hit, tri_c >= 0)
        tie = (a.t - c.t).abs() <= 1e-6 * c.t.abs()
        same = a.tri == tri_c
        assert not (hit & ~same & ~tie).any()
        for x, y in ((a.t, c.t), (a.u, c.u), (a.v, c.v)):
            assert torch.equal(x[same], y[same])
        b = ttrace.intersect_scene(sah, o, d)
        ha, hb = (a.tri >= 0).numpy(), (b.tri >= 0).numpy()
        assert (ha == hb).mean() >= 0.999
        both = ha & hb
        ta, tb = a.t.numpy(), b.t.numpy()
        near = (np.minimum(ta, tb).astype(np.float64)
                * np.linalg.norm(rays[:, 3:], axis=1) < 1e-3)
        tie = np.abs(ta - tb) <= 5e-4 * np.abs(tb)
        assert (tie | near)[both].all()
        assert not (both & (a.tri.numpy() != b.tri.numpy()) & ~tie
                    & ~near).any()
        assert (a.tri.numpy() == b.tri.numpy())[both].mean() > 0.99


def _host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    kernels.load_host_library()


@pytest.mark.parametrize("k", [1, 4])
def test_kernel_walk_host_build_matches_plain(k):
    """The per-ray walk the traverse1 kernel runs, built with g++: ids
    equal to the plain version's outside 1e-6-relative t ties, t, u, v
    equal bit for bit where the ids agree; inactive lanes (0, -1, 0, 0);
    the walk's counts positive, additive and repeatable."""
    _host_lib()
    s = _sponza()
    host = s["host"]
    heap = (s["heap"] if k == 4 else
            build_device_scene(host, leaf_size=k, device="cpu"))
    tables = [heap.bvh_children, heap.bvh_leaves, heap.bvh_ni, k,
              heap.bvh_leaves.shape[0]]
    rs = np.random.RandomState(16)
    r = 4096
    v = host.tri_v.reshape(-1, 3)
    o = rs.uniform(v.min(0), v.max(0), (r, 3)).astype(np.float32)
    d = rs.randn(r, 3).astype(np.float32)

    def run(o, d, active=None):
        c = torch.zeros(2, dtype=torch.int64)
        hit = kernels.run_host("traverse1", tables, tv3(o), tv3(d),
                               active=active, counts=c)
        return hit, c.tolist()

    (t, tri, u, v_), counts = run(o, d)
    p = t1.traverse1_plain(heap.bvh_children, heap.bvh_leaves, heap.bvh_ni,
                           k, tv3(o), tv3(d))
    hit = p.tri >= 0
    assert 0.2 < hit.float().mean() < 1.0
    assert ((tri >= 0) == hit).all()
    tie = (t - p.t).abs() <= 1e-6 * p.t.abs()
    assert not (hit & (tri != p.tri) & ~tie).any()
    same = ~hit | (tri == p.tri)
    for a, b in ((t, p.t), (u, p.u), (v_, p.v)):
        assert torch.equal(a[same], b[same])
    assert (t[~hit] == np.float32(3e38)).all()

    active = torch.from_numpy(rs.rand(r) < 0.5)
    (t3, tri3, u3, v3), _ = run(o, d, active)
    ina = ~active
    assert (t3[ina] == 0).all() and (tri3[ina] == -1).all()
    assert (u3[ina] == 0).all() and (v3[ina] == 0).all()
    assert torch.equal(tri3[active], tri[active])
    assert torch.equal(t3[active], t[active])

    boxes, leaves = counts
    assert boxes > leaves >= int(hit.sum()) > 0
    assert run(o, d)[1] == counts
    halves = [run(o[sl], d[sl])[1] for sl in (slice(0, r // 2),
                                               slice(r // 2, r))]
    assert [a + b for a, b in zip(*halves)] == counts
    assert run(o, d, torch.zeros(r, dtype=torch.bool))[1] == [0, 0]


# Work of traverse1's walk at K = 4 on the pinned rays of sponza_proc
# scale 1 (tests/torch_common.py:pinned_rays): [child boxes slab-tested,
# leaves tested], counted by the host build of the walk as it stood
# before the kernel's redesign, which keeps the order of the walk, and
# since the tie rule (csrc/bvh8_walk.cuh), which also enters the boxes
# at t_best: [428080, 17108] and [481688, 20572] before it.
_PINNED1 = {"primary": [431896, 17318], "bounce": [485368, 20835]}


def _heap_frame():
    s = _sponza()
    if "rays" not in s:
        heap = s["heap"]
        s["tables"] = [heap.bvh_children, heap.bvh_leaves, heap.bvh_ni, 4,
                       heap.bvh_leaves.shape[0]]
        s["rays"] = pinned_rays(heap, s["cam"])
    return s["tables"], s["rays"]


@pytest.mark.parametrize("which", ["primary", "bounce"])
def test_kernel_walk_pinned_counts(which):
    _host_lib()
    tables, rays = _heap_frame()
    q = rays[which]
    counts = torch.zeros(2, dtype=torch.int64)
    kernels.run_host("traverse1", tables, V3(*q[:3]), V3(*q[3:]),
                     counts=counts)
    assert counts.tolist() == _PINNED1[which]


@pytest.mark.parametrize("mask", ["none", "one", "sparse", "all"])
def test_kernel_walk_matches_plain_under_masks(mask):
    """The host build of traverse1's walk at K = 4 against
    traverse1_plain on the pinned primary and bounce rays, with no lane,
    one lane, about 45 % (seeded) and every lane active: equal bit for
    bit where the ids agree, ids equal outside equal-t ties."""
    _host_lib()
    tables, rays = _heap_frame()
    for q in rays.values():
        o, d = V3(*q[:3]), V3(*q[3:])
        active = lane_mask(mask, q.shape[1], 33)
        host = kernels.run_host("traverse1", tables, o, d, active=active)
        plain = t1.traverse1_plain(*tables[:4], o, d, active=active)
        host_vs_plain(host, plain)
        assert int((host.tri >= 0).sum()) <= int(active.sum())
        assert (host.t[~active] == 0).all()


def test_scene_build_checks(tmp_path):
    glb = tmp_path / "cube.glb"
    glb.write_bytes(tfix.cube_scene_glb())
    scene, host = load_scene(str(glb), leaf_size=4, device="cpu")
    assert scene.has_heap and scene.leaf_size == 4
    assert host.num_triangles == scene.num_triangles == 16
    host = _sponza()["host"]
    with pytest.raises(ValueError, match="leaf_size"):
        build_device_scene(host, leaf_size=0, device="cpu")
    deep = build_device_scene(host, leaf_size=1, device="cpu")
    assert deep.bvh_depth == twbvh.plan(host.num_triangles, 1)[0]
    assert deep.bvh_leaves.shape == (host.num_triangles, 9)
    assert deep.shade_tbl.shape[0] == 8 ** deep.bvh_depth
    # a CPU tensor runs the plain version and counts no launch
    before = t1.traverse1.launches
    o = tv3(np.zeros((8, 3), np.float32))
    d = tv3(np.ones((8, 3), np.float32))
    hit = ttrace.intersect_scene(deep, o, d)
    assert t1.traverse1.launches == before and hit.t.shape == (8,)
    meta = [x.to("meta") for x in (deep.bvh_children, deep.bvh_leaves)]
    with pytest.raises(ValueError):
        t1.traverse1(*meta, deep.bvh_ni, 1, o, d)
