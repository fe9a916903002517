"""Port intersectors against the Pallas kernels they replace or cover
(traverse_packets8; traverse_packets5, 2 and 6 through traverse5's MT
mode) run in interpret mode on the CPU, through the same pallas_call
patch as tests/test_pallas.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sycl_ray_tracer_tpu.ops import sah as jsah
from sycl_ray_tracer_tpu.ops import wbvh as jwbvh
from sycl_ray_tracer_tpu.ops import woop as jwoop
from sycl_ray_tracer_tpu.ops.intersect import intersect_brute_np
from sycl_ray_tracer_tpu.ops.vec import V3 as JV3
from sycl_ray_tracer_tpu.utils.fixtures import cube_scene_glb
from sycl_ray_tracer_tpu.utils.gltf import load_glb
from sycl_ray_tracer_torch.models.scene import build_device_scene
from sycl_ray_tracer_torch.ops.traverse5 import (tables_from_tiles,
                                                 traverse5_plain)
from sycl_ray_tracer_torch.ops.traverse8 import traverse8_plain
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils import gltf as tgltf

from tests.torch_common import jv3, tv3


def test_plain_matches_traverse_packets8_interpret():
    import sycl_ray_tracer_tpu.ops.traverse_pallas8 as TP8

    host = load_glb(cube_scene_glb())
    sahb = jsah.build_sah(host.tri_v, 8)
    rows = jsah.leaf_rows(host.tri_v, sahb.order, 8)
    ct, _ = jwbvh.pack_tiles_np(sahb.children, sahb.child_ids, rows, 8)
    wt = jwoop.pack_wtiles_affine_np(rows)

    rs = np.random.RandomState(3)
    r = 1024
    o = np.broadcast_to(np.asarray(host.camera_position, np.float32),
                        (r, 3)).copy()
    d = rs.randn(r, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jo = JV3(*(jnp.asarray(o[:, i]) for i in range(3)))
    jd = JV3(*(jnp.asarray(d[:, i]) for i in range(3)))

    orig = TP8.pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    TP8.pl.pallas_call = patched
    try:
        ref = TP8.traverse_packets8(jnp.asarray(ct), jnp.asarray(wt),
                                    sahb.num_internal, 8, jo, jd)
        ref2 = TP8.traverse_packets8(jnp.asarray(ct), jnp.asarray(wt),
                                     sahb.num_internal, 8, jo, jd,
                                     t_init=ref.t)
    finally:
        TP8.pl.pallas_call = orig

    scene = build_device_scene(tgltf.load_glb(tfix.cube_scene_glb()),
                               device="cpu")
    assert scene.sah_ni == sahb.num_internal
    args = (scene.bvh_nodes, scene.bvh_child_ids, scene.bvh_woop,
            scene.sah_ni, tv3(o), tv3(d))
    hit = traverse8_plain(*args)
    tri, rtri = hit.tri.numpy(), np.asarray(ref.tri)
    assert ((tri < 0) == (rtri < 0)).all()
    both = rtri >= 0
    assert both.mean() > 0.2
    assert (tri[both] == rtri[both]).all()
    np.testing.assert_allclose(hit.t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hit.u.numpy()[both], np.asarray(ref.u)[both],
                               atol=1e-4)
    np.testing.assert_allclose(hit.v.numpy()[both], np.asarray(ref.v)[both],
                               atol=1e-4)
    # t_init chaining gives no hit on either side
    assert (np.asarray(ref2.tri) == -1).all()
    again = traverse8_plain(*args, t_init=hit.t)
    assert (again.tri.numpy() == -1).all()


def _interpret(module, fn, *args, **kw):
    """Call sycl_ray_tracer_tpu.ops.<module>.<fn> with pallas_call in
    interpret mode."""
    import importlib

    mod = importlib.import_module(f"sycl_ray_tracer_tpu.ops.{module}")
    orig = mod.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    mod.pl.pallas_call = patched
    try:
        return getattr(mod, fn)(*args, **kw)
    finally:
        mod.pl.pallas_call = orig


def _heap_scene(n, seed, sliver=False):
    """The Morton-heap scenes of tests/test_pallas.py: n small random
    triangles (:82-124), or n long slivers whose boxes overlap
    everything (:233-293). Returns (tiles, MT tables, Morton-sorted
    triangles for intersect_brute_np)."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(-5, 5, (n, 3)).astype(np.float32)
    if sliver:
        c = rs.uniform(-4, 4, (n, 3)).astype(np.float32)
        e1 = rs.normal(0, 1, (n, 3)).astype(np.float32)
        e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
        e1 *= 8.0
        e2 = rs.normal(0, 0.05, (n, 3)).astype(np.float32)
        tri = np.stack([c - 0.5 * e1, c + 0.5 * e1, c + e2], axis=1)
    else:
        tri = c[:, None, :] + rs.uniform(-0.3, 0.3, (n, 3, 3)).astype(
            np.float32)
    bvh, sorted_v, _ = jwbvh.build_np(tri, 8)
    ids = jwbvh.heap_child_ids_np(bvh.num_internal)
    ct, lt = jwbvh.pack_tiles_np(np.asarray(bvh.children), ids,
                                 np.asarray(bvh.leaves), 8)
    return (ct, lt), tables_from_tiles(ct, lt, bvh.num_internal), \
        np.asarray(sorted_v)


def _plain(tb, o, d, **kw):
    return traverse5_plain(torch.from_numpy(tb.nodes),
                           torch.from_numpy(tb.child_ids),
                           torch.from_numpy(tb.mt), tb.nodes.shape[0],
                           tv3(o), tv3(d), **kw)


def _assert_same_hits(hit, ref):
    """Ids equal outside 1e-6-relative t ties, t rtol 1e-4, u/v atol
    1e-4 (XLA may fuse multiply-adds that torch rounds twice)."""
    tri, rtri = hit.tri.numpy(), np.asarray(ref.tri)
    t, rt = hit.t.numpy(), np.asarray(ref.t)
    assert ((tri >= 0) == (rtri >= 0)).all()
    both = rtri >= 0
    tie = np.abs(t - rt) <= 1e-6 * np.abs(rt)
    assert not (both & (tri != rtri) & ~tie).any()
    np.testing.assert_allclose(t[both], rt[both], rtol=1e-4)
    same = both & (tri == rtri)
    np.testing.assert_allclose(hit.u.numpy()[same], np.asarray(ref.u)[same],
                               atol=1e-4)
    np.testing.assert_allclose(hit.v.numpy()[same], np.asarray(ref.v)[same],
                               atol=1e-4)
    return both


@pytest.mark.parametrize("kernel", ["v5", "v2", "v6"])
def test_traverse5_mt_mode_matches_pallas_interpret(kernel):
    """traverse5's MT mode computes the function of traverse_packets5,
    traverse_packets2 and traverse_packets6 on their own tables (the
    Morton heap of tests/test_pallas.py:82-124, unpacked by
    tables_from_tiles). v5 also chains t_init; v6 serves primary rays
    (one origin, no t_init)."""
    (ct, lt), tb, sorted_v = _heap_scene(1500, 7)
    ni = tb.nodes.shape[0]
    rs = np.random.RandomState(8)
    r = 1024
    if kernel == "v6":
        o = np.broadcast_to(np.float32([0.5, 1.0, 9.0]), (r, 3)).copy()
        d = np.concatenate([rs.uniform(-0.6, 0.6, (r, 2)),
                            -np.ones((r, 1))], axis=1).astype(np.float32)
    else:
        o = rs.uniform(-8, 8, (r, 3)).astype(np.float32)
        d = rs.uniform(-1, 1, (r, 3)).astype(np.float32)
    jct, jlt = jnp.asarray(ct), jnp.asarray(lt)
    call = {"v5": ("traverse_pallas5", "traverse_packets5"),
            "v2": ("traverse_pallas2", "traverse_packets2"),
            "v6": ("traverse_pallas6", "traverse_packets6")}[kernel]
    ref = _interpret(*call, jct, jlt, ni, 8, jv3(o), jv3(d))
    hit = _plain(tb, o, d)
    both = _assert_same_hits(hit, ref)
    assert both.mean() > (0.2 if kernel == "v6" else 0.05)
    # and against brute force on the Morton-sorted triangles
    t_b, id_b, _, _ = intersect_brute_np(o, d, sorted_v)
    assert ((hit.tri.numpy() >= 0) == (id_b >= 0)).all()
    assert (hit.tri.numpy()[both] == id_b[both]).all()
    if kernel == "v5":
        ref2 = _interpret(*call, jct, jlt, ni, 8, jv3(o), jv3(d),
                          t_init=ref.t)
        again = _plain(tb, o, d, t_init=hit.t)
        assert (np.asarray(ref2.tri) == -1).all()
        assert (again.tri.numpy() == -1).all()


def test_traverse5_mt_mode_sliver_stress_matches_brute():
    """tests/test_pallas.py:233-293's slivers: every node box covers
    nearly everything, so the walk keeps most of the tree on its stack
    at once; exact ids against intersect_brute_np."""
    _, tb, sorted_v = _heap_scene(6000, 9, sliver=True)
    rs = np.random.RandomState(10)
    r = 1024
    o = rs.uniform(-8, 8, (r, 3)).astype(np.float32)
    d = (rs.uniform(-2, 2, (r, 3)).astype(np.float32) - o).astype(
        np.float32)
    hit = _plain(tb, o, d)
    t_b, id_b, _, _ = intersect_brute_np(o, d, sorted_v)
    tri = hit.tri.numpy()
    assert (id_b >= 0).mean() > 0.9
    assert ((tri >= 0) == (id_b >= 0)).all()
    both = tri >= 0
    assert (tri[both] == id_b[both]).all()
    np.testing.assert_allclose(hit.t.numpy()[both], t_b[both], rtol=1e-3,
                               atol=1e-4)
