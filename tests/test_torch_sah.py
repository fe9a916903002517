"""Port SAH build with SBVH spatial splits (ops/sah.py): the counterpart
of tests/test_sah.py. The port's build_sah and validate against the JAX
package's, the walks of traverse8 and traverse5 (plain torch, and the
g++ build of csrc/walk_regs.cuh) on a tree whose splits duplicated
references, against brute force and the JAX v2 kernel in interpret
mode, and SRT_SBVH=1 through build_device_scene."""

import numpy as np
import pytest
import torch

from sycl_ray_tracer_tpu.ops import sah as jsah
from sycl_ray_tracer_tpu.ops import wbvh as jwbvh
from sycl_ray_tracer_tpu.ops.intersect import intersect_brute_np
from sycl_ray_tracer_torch.models.camera import make_camera
from sycl_ray_tracer_torch.models.instanced import (
    build_instanced_device_scene)
from sycl_ray_tracer_torch.models.oracle import render_oracle
from sycl_ray_tracer_torch.models.scene import build_device_scene
from sycl_ray_tracer_torch.models.wavefront import render_wavefront
from sycl_ray_tracer_torch.ops import kernels
from sycl_ray_tracer_torch.ops import sah as tsah
from sycl_ray_tracer_torch.ops import traverse5 as t5
from sycl_ray_tracer_torch.ops import traverse8 as t8
from sycl_ray_tracer_torch.ops import woop as twoop
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils import procgen as tproc
from sycl_ray_tracer_torch.utils.gltf import load_glb
from sycl_ray_tracer_torch.utils.instanced import (InstancedHostScene,
                                                   UniquePrim,
                                                   load_glb_instanced)

from tests.test_render import check_oracle_match
from tests.torch_common import jv3, tv3

torch.set_num_threads(1)


def _random_tris(rs, n, spread=5.0, size=0.3):
    c = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return c[:, None, :] + rs.uniform(-size, size, (n, 3, 3)).astype(
        np.float32)


_CACHE = {}


def _sbvh():
    """(triangles, rays o, d, the port's SBVH, the JAX package's SBVH,
    the brute-force (t, id)) of the straddler scene."""
    if not _CACHE:
        tri, o, d = tfix.straddler_scene()
        t_b, id_b, _, _ = intersect_brute_np(o, d, tri)
        _CACHE.update(tri=tri, o=o, d=d,
                      port=tsah.build_sah(tri, 8, spatial=True),
                      jax=jsah.build_sah(tri, 8, spatial=True),
                      brute=(t_b, id_b))
    return _CACHE


@pytest.mark.parametrize("n,leaves", [(3000, None), (5, 1)])
def test_validate_object_build(n, leaves):
    tri = _random_tris(np.random.RandomState(n), n)
    b = tsah.build_sah(tri, 8, spatial=False)
    tsah.validate(b, tri)
    assert b.num_refs == n
    assert (b.child_ids >= 0).all()
    assert (b.child_ids < b.num_internal + b.num_leaves).all()
    if leaves is None:
        assert b.depth >= 2
    else:
        assert b.num_leaves == leaves


def test_sbvh_build_equals_jax():
    """On the straddler scene (utils/fixtures.py, the construction of
    tests/test_sah.py:121-131) splits fire, and the port's build equals
    the JAX package's array for array; both validates accept it."""
    c = _sbvh()
    tri, b, j = c["tri"], c["port"], c["jax"]
    for f in ("children", "child_ids", "order"):
        assert np.array_equal(getattr(b, f), getattr(j, f)), f
    assert (b.num_internal, b.num_leaves, b.depth, b.num_refs) == (
        j.num_internal, j.num_leaves, j.depth, j.num_refs)
    assert b.num_refs > tri.shape[0], "no spatial split fired"
    seen = b.order[b.order >= 0]
    assert len(seen) == b.num_refs
    assert len(np.unique(seen)) == tri.shape[0]
    tsah.validate(b, tri)
    jsah.validate(j, tri)


def test_validate_rejects_duplicated_reference():
    """An object-split tree with one reference duplicated into a padding
    slot fails on its declared num_refs, as the JAX validate does; the
    same data declared spatial passes the count check."""
    tri = _random_tris(np.random.RandomState(7), 3000)
    b = tsah.build_sah(tri, 8, spatial=False)
    order = b.order.copy()
    pad = np.nonzero(order < 0)[0][0]
    order[pad] = order[pad - 1]
    bad = b._replace(order=order)
    with pytest.raises(ValueError, match="duplicated reference"):
        tsah.validate(bad, tri)
    with pytest.raises(AssertionError, match="duplicated reference"):
        jsah.validate(jsah.SahBvh(**{**bad._asdict(), "width": 8}), tri)
    tsah.validate(bad._replace(num_refs=b.num_refs + 1), tri)
    with pytest.raises(ValueError, match="reference count"):
        tsah.validate(bad._replace(num_refs=b.num_refs + 2), tri)


def test_sbvh_switch_read_at_call(monkeypatch):
    """spatial=None reads SRT_SBVH at each call (on only for "1"); the
    split settings are the JAX package's defaults."""
    tri, b = _sbvh()["tri"], _sbvh()["port"]
    monkeypatch.delenv("SRT_SBVH", raising=False)
    assert tsah.build_sah(tri, 8).num_refs == tri.shape[0]
    monkeypatch.setenv("SRT_SBVH", "true")
    assert tsah.build_sah(tri, 8).num_refs == tri.shape[0]
    monkeypatch.setenv("SRT_SBVH", "1")
    on = tsah.build_sah(tri, 8)
    assert np.array_equal(on.order, b.order) and on.num_refs == b.num_refs
    assert (tsah.SBVH_ALPHA, tsah.SBVH_FACTOR) == (jsah._SBVH_ALPHA,
                                                   jsah._SBVH_FACTOR)


def _sbvh_tables():
    """traverse8's and traverse5 MT's tables of the straddler SBVH."""
    c = _sbvh()
    tri, b = c["tri"], c["port"]
    rows = tsah.leaf_rows(tri, b.order, 8)
    m, tr, _ = twoop.woop_from_leaf_rows(rows, 8)
    nodes = torch.from_numpy(b.children)
    ids = torch.from_numpy(b.child_ids)
    woop = torch.from_numpy(np.concatenate([m.reshape(-1, 9),
                                            tr.reshape(-1, 3)], axis=1))
    mt = torch.from_numpy(tsah.slot_rows(rows, 8))
    return {"traverse8": [nodes, ids, woop, b.num_internal],
            "traverse5": [nodes, ids, mt, None, None, b.num_internal]}


def _walk(walk):
    c = _sbvh()
    o, d = tv3(c["o"]), tv3(c["d"])
    tables = _sbvh_tables()
    if walk == "traverse8-plain":
        return t8.traverse8_plain(*tables["traverse8"], o, d)
    if walk == "traverse5-plain":
        nodes, ids, mt, _, _, ni = tables["traverse5"]
        return t5.traverse5_plain(nodes, ids, mt, ni, o, d)
    kernels.load_host_library()
    return kernels.run_host(walk.split("-")[0],
                            tables[walk.split("-")[0]], o, d)


def _interp_v2():
    """The JAX package's traverse_packets2 in interpret mode on the
    JAX build of the straddler SBVH (tests/test_sah.py:144-152)."""
    if "v2" not in _CACHE:
        import jax.numpy as jnp
        from jax.experimental import pallas as pl

        import sycl_ray_tracer_tpu.ops.traverse_pallas2 as TP2

        c = _sbvh()
        j = c["jax"]
        ct, lt = jwbvh.pack_tiles_np(
            j.children, j.child_ids, jsah.leaf_rows(c["tri"], j.order, 8), 8)
        orig = pl.pallas_call
        TP2.pl.pallas_call = lambda *a, **kw: orig(
            *a, **{**kw, "interpret": True})
        try:
            hit = TP2.traverse_packets2(jnp.asarray(ct), jnp.asarray(lt),
                                        j.num_internal, 8, jv3(c["o"]),
                                        jv3(c["d"]), rows=2)
        finally:
            TP2.pl.pallas_call = orig
        _CACHE["v2"] = np.asarray(hit.t), np.asarray(hit.tri)
    return _CACHE["v2"]


def _ids(order, slot):
    slot = np.asarray(slot)
    return np.where(slot >= 0, order[np.maximum(slot, 0)], -1)


@pytest.mark.parametrize("walk", ["traverse8-plain", "traverse5-plain",
                                  "traverse8-host", "traverse5-host"])
def test_walks_on_sbvh_match_brute_and_v2(walk):
    """Each walk on the SBVH tables returns the brute-force triangle ids
    exactly after the SAH order (a duplicated triangle's slots map to
    its one id), and the ids of the JAX v2 kernel in interpret mode on
    the JAX build of the same tree; t as tests/test_sah.py compares it
    (the large straddlers amplify f32 rounding)."""
    c = _sbvh()
    order = c["port"].order
    t_b, id_b = c["brute"]
    hit = _walk(walk)
    got = _ids(order, hit.tri.numpy())
    assert (got >= 0).mean() > 0.3
    assert np.array_equal(got, id_b)
    both = got >= 0
    np.testing.assert_allclose(hit.t.numpy()[both], t_b[both], rtol=2e-4,
                               atol=1e-5)
    v2_t, v2_tri = _interp_v2()
    assert np.array_equal(got, _ids(c["jax"].order, v2_tri))
    np.testing.assert_allclose(hit.t.numpy()[both], v2_t[both], rtol=2e-4,
                               atol=1e-5)


def test_duplicated_slots_tie_and_share_a_morton_slot(monkeypatch):
    """On sponza_like_glb(scale=1) with SRT_SBVH=1 the baked scene's
    tables hold every reference: the slots of a duplicated triangle
    carry Woop rows equal bit for bit and remap to one Morton slot."""
    host = load_glb(tproc.sponza_like_glb(scale=1))
    b = tsah.build_sah(host.tri_v, 8, spatial=True)
    assert b.num_refs > host.num_triangles
    monkeypatch.setenv("SRT_SBVH", "1")
    scene = build_device_scene(host, device="cpu")
    remap = scene.bvh_remap.numpy()
    woop = scene.bvh_woop.numpy()
    assert scene.sah_ni == b.num_internal
    assert remap.shape[0] == b.num_leaves * 8
    order = b.order
    valid = order >= 0
    first = {}
    dups = 0
    for slot in np.nonzero(valid)[0]:
        tri = int(order[slot])
        if tri in first:
            dups += 1
            assert remap[slot] == remap[first[tri]]
            assert np.array_equal(woop[slot], woop[first[tri]])
        else:
            first[tri] = slot
    assert dups == b.num_refs - host.num_triangles
    assert len(np.unique(remap[valid])) == host.num_triangles
    assert 7 * scene.bvh_depth + 1 <= kernels.STACK


def _straddler_instanced():
    """Two instances of the straddler primitive, the second moved and
    turned, shaded with the cube fixture's materials in turn and viewed
    from +z."""
    tri = _sbvh()["tri"]
    n = tri.shape[0]
    m1 = np.eye(4)
    m1[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    m1[:3, 3] = [3.0, -2.0, 1.0]
    host = load_glb(tfix.cube_scene_glb())
    face = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    prim = UniquePrim(
        tri_v=tri, tri_n=np.repeat(face[:, None], 3, 1).astype(np.float32),
        tri_uv=np.zeros((n, 3, 2), np.float32),
        tri_mat=(np.arange(n) % host.materials.mtype.shape[0]).astype(
            np.int32))
    return InstancedHostScene(
        prims=[prim], inst_prim=np.zeros(2, np.int32),
        inst_mat=np.stack([np.eye(4), m1]), materials=host.materials,
        textures=host.textures, sky_color=host.sky_color,
        camera_position=np.array([0.0, 0.0, 24.0], np.float32),
        camera_direction=np.array([0.0, 0.0, -1.0], np.float32),
        camera_focal_length=host.camera_focal_length)


def test_itf_walk_on_sbvh_blas_matches_brute(monkeypatch):
    """Two instances of the straddler primitive, the second moved and
    turned: with SRT_SBVH=1 the shared BLAS duplicates references, and
    traverse5's itf walk (plain torch and the host build) returns the
    brute-force ids of the baked scene after bvh_remap."""
    c = _sbvh()
    tri = c["tri"]
    n = tri.shape[0]
    ih = _straddler_instanced()
    monkeypatch.setenv("SRT_SBVH", "1")
    ts = build_instanced_device_scene(ih, device="cpu")
    b = tsah.build_sah(tri, 8, spatial=True)
    assert ts.inst_s8 == b.num_leaves * 8
    baked = ih.bake().tri_v
    t_b, id_b, _, _ = intersect_brute_np(c["o"], c["d"], baked)
    tables = [ts.bvh_nodes, ts.bvh_child_ids, ts.bvh_mt, ts.inst_leaf_slot,
              ts.inst_xf, ts.sah_ni]
    o, d = tv3(c["o"]), tv3(c["d"])
    kernels.load_host_library()
    for hit in (t5.traverse5_plain(*tables[:3], ts.sah_ni, o, d,
                                   leaf_slot=tables[3], leaf_xf=tables[4]),
                kernels.run_host("traverse5", tables, o, d)):
        slot = hit.tri.numpy()
        comp = ts.bvh_remap.numpy()[np.maximum(slot, 0)]
        inst, row = comp // ts.inst_s8, comp % ts.inst_s8
        got = np.where(slot >= 0, inst * n + b.order[row], -1)
        assert np.array_equal(got, id_b)
        both = got >= 0
        np.testing.assert_allclose(hit.t.numpy()[both], t_b[both],
                                   rtol=2e-4, atol=1e-5)


_RENDERS = {"cube": (96, 96, 4, 8), "textured": (64, 64, 4, 4),
            "instanced": (64, 64, 16, 6), "sponza": (32, 24, 8, 2)}


def _fixture_scene(name):
    """(scene built now, host to render the oracle from, the triangles
    of its one SAH build: the baked scene's or the shared BLAS's)."""
    if name == "instanced":
        ih = load_glb_instanced(tfix.instanced_scene_glb(30))
        return (build_instanced_device_scene(ih, device="cpu"), ih.bake(),
                None)
    if name == "straddlers_instanced":
        ih = _straddler_instanced()
        return (build_instanced_device_scene(ih, device="cpu"), ih.bake(),
                ih.prims[0].tri_v)
    if name == "straddlers":
        host = _straddler_instanced().bake()
    elif name == "sponza":
        host = load_glb(tproc.sponza_like_glb(scale=1))
    else:
        host = load_glb(getattr(tfix, f"{name}_scene_glb")())
    return build_device_scene(host, device="cpu"), host, host.tri_v


def _frames(name, width, height, spp, depth, monkeypatch):
    """The object-split and SRT_SBVH=1 scenes of fixture `name`, the host
    and the camera; each scene's wavefront frame (image, tallies) on the
    CPU."""
    kw = dict(width=width, height=height, spp=spp, max_depth=depth, seed=0)
    monkeypatch.delenv("SRT_SBVH", raising=False)
    obj, host, tri = _fixture_scene(name)
    monkeypatch.setenv("SRT_SBVH", "1")
    sbvh, _, _ = _fixture_scene(name)
    cam = make_camera(width, height, host.camera_position,
                      host.camera_direction, host.camera_focal_length,
                      device="cpu")
    frames = [tuple(x.numpy() for x in render_wavefront(s, cam, **kw))
              for s in (sbvh, obj)]
    return obj, sbvh, host, tri, cam, kw, frames


def _splits_fired(obj, sbvh, tri):
    b = tsah.build_sah(tri, 8, spatial=True)
    assert b.num_refs > tri.shape[0], "no spatial split fired"
    assert sbvh.bvh_remap.shape[0] > obj.bvh_remap.shape[0]


@pytest.mark.parametrize("name", list(_RENDERS))
def test_sbvh_env_renders_fixtures(monkeypatch, name):
    """SRT_SBVH=1 through build_device_scene (baked cube, textured quad
    and sponza_like_glb(scale=1)) and build_instanced_device_scene (the
    instanced fixture). On the fixtures' small primitives no split
    fires, so the traversal tables equal the object-split ones byte for
    byte; on Sponza splits fire, so duplicated references go through the
    remap, the shading rows and the tallies. Each frame passes the
    flip-tolerant gate against the object-split frame and against the
    port's numpy oracle, with the tallies within the flip tail."""
    obj, sbvh, host, tri, cam, kw, frames = _frames(
        name, *_RENDERS[name], monkeypatch)
    if name == "sponza":
        _splits_fired(obj, sbvh, tri)
    else:
        for f in ("bvh_nodes", "bvh_child_ids", "bvh_woop", "bvh_mt",
                  "bvh_remap", "inst_leaf_slot", "inst_xf", "shade_tbl"):
            a, b = getattr(obj, f), getattr(sbvh, f)
            assert (a is None) == (b is None), f
            assert a is None or torch.equal(a, b), f
    (img, rays), (ref, ref_rays) = frames
    check_oracle_match(img, ref)
    check_oracle_match(img, render_oracle(host, cam, **kw))
    assert (np.abs(rays - ref_rays) <= np.maximum(16, 0.005 * ref_rays)).all()
    assert img.mean() > 0.01


@pytest.mark.parametrize("name", ["straddlers", "straddlers_instanced"])
def test_sbvh_straddler_frames_equal_object_split(monkeypatch, name):
    """Two straddler instances (_straddler_instanced), baked (traverse8's
    Woop leaves) and two-level (traverse5 itf on the shared BLAS): splits
    fire, and the SRT_SBVH=1 frame and tallies equal the object-split
    ones bit for bit. The judge is the object-split frame, not the
    oracle: these triangles interpenetrate, so a bounce ray leaves one
    where it meets another, at a t next to TNEAR, and there the walks'
    leaf arithmetic (Woop rows, or MT in the instance's frame) and the
    oracle's world-space brute force round apart, on either tree alike
    (ROADMAP Queue 3, "Woop against MT t")."""
    obj, sbvh, _, tri, _, _, frames = _frames(name, 48, 48, 4, 4,
                                              monkeypatch)
    _splits_fired(obj, sbvh, tri)
    (img, rays), (ref, ref_rays) = frames
    assert np.array_equal(img, ref) and np.array_equal(rays, ref_rays)
    assert img.mean() > 0.01 and rays[-1] > 0
