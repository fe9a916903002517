"""Two-level instancing in the port (utils/instanced.py,
models/instanced.py, ops/traverse5.py itf mode, the instanced branch of
models/trace.py) against the JAX package on the same inputs: the
loader, the tables (unpacked from the JAX build's TPU tiles), the
traversal against interpret-mode traverse_packets5 with leaf
descriptors, shading, and a render against the JAX render of the baked
scene."""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sycl_ray_tracer_tpu.models import trace as jtrace
from sycl_ray_tracer_tpu.models.camera import make_camera as jmake_camera
from sycl_ray_tracer_tpu.models.instanced import (
    build_instanced_device_scene as jbuild_instanced)
from sycl_ray_tracer_tpu.models.scene import build_device_scene as jbuild
from sycl_ray_tracer_tpu.models.wavefront import render_wavefront as jrender
from sycl_ray_tracer_tpu.ops.intersect import Hit as JHit
from sycl_ray_tracer_tpu.utils.instanced import (
    load_glb_instanced as jload_instanced)
from sycl_ray_tracer_torch.models import trace as ttrace
from sycl_ray_tracer_torch.models.camera import make_camera
from sycl_ray_tracer_torch.models.instanced import (
    build_instanced_device_scene)
from sycl_ray_tracer_torch.models.scene import build_device_scene
from sycl_ray_tracer_torch.models.wavefront import render_wavefront
from sycl_ray_tracer_torch.ops.traverse5 import (tables_from_tiles,
                                                 traverse5_plain)
from sycl_ray_tracer_torch.utils.fixtures import instanced_scene_glb
from sycl_ray_tracer_torch.utils.gltf import load_glb
from sycl_ray_tracer_torch.utils.instanced import load_glb_instanced

from tests.test_render import check_oracle_match
from tests.torch_common import jv3, np3, tv3

_CACHE = {}


def _pair(r):
    """(port InstancedHostScene, port DeviceScene on the cpu, JAX
    InstancedHostScene, JAX DeviceScene) of instanced_scene_glb(r)."""
    if r not in _CACHE:
        glb = instanced_scene_glb(r)
        ih = load_glb_instanced(glb)
        jh = jload_instanced(glb)
        _CACHE[r] = (ih, build_instanced_device_scene(ih, device="cpu"),
                     jh, jbuild_instanced(jh))
    return _CACHE[r]


def _rays(ih, r, seed):
    """Half rays from the camera, half from random points inside the
    instances' bounds, random unit directions."""
    rs = np.random.RandomState(seed)
    o = np.broadcast_to(ih.camera_position.astype(np.float32),
                        (r, 3)).copy()
    t = ih.inst_mat[:, :3, 3]
    o[r // 2:] = rs.uniform(t.min(0) - 1, t.max(0) + 1, (r - r // 2, 3))
    d = rs.randn(r, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d


def _interp5(*args, **kw):
    import sycl_ray_tracer_tpu.ops.traverse_pallas5 as TP5

    orig = TP5.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    TP5.pl.pallas_call = patched
    try:
        return TP5.traverse_packets5(*args, **kw)
    finally:
        TP5.pl.pallas_call = orig


def test_loader_matches_jax_and_bake_matches_native():
    ih, _, jh, _ = _pair(50)
    assert ih.num_instances == jh.num_instances > 50
    assert len(ih.prims) == len(jh.prims)
    for a, b in zip(ih.prims, jh.prims):
        for f in ("tri_v", "tri_n", "tri_uv", "tri_mat"):
            assert (getattr(a, f) == getattr(b, f)).all(), f
    assert (ih.inst_prim == jh.inst_prim).all()
    assert (ih.inst_mat == jh.inst_mat).all()
    for f in ("mtype", "albedo", "tex_id", "roughness", "ior", "emissive"):
        assert (getattr(ih.materials, f) == getattr(jh.materials, f)).all()
    assert (ih.textures == jh.textures).all()
    for f in ("sky_color", "camera_position", "camera_direction"):
        assert (getattr(ih, f) == getattr(jh, f)).all(), f
    assert ih.camera_focal_length == jh.camera_focal_length
    assert ih.num_world_triangles == jh.num_world_triangles
    assert ih.num_unique_triangles < ih.num_world_triangles / 5
    # bake() reproduces the native baked ingest bit for bit
    hb = load_glb(instanced_scene_glb(50))
    b = ih.bake()
    assert b.tri_v.shape == hb.tri_v.shape
    assert (b.tri_v == hb.tri_v).all()
    assert (b.tri_mat == hb.tri_mat).all()
    assert (b.tri_n == hb.tri_n).all()


def test_instanced_tables_match_jax_tiles():
    _, ts, _, js = _pair(30)
    tb = tables_from_tiles(np.asarray(js.bvh_ctiles),
                           np.asarray(js.bvh_ltiles), js.sah_ni,
                           np.asarray(js.inst_ldesc))
    assert ts.has_instances and ts.sah_ni == js.sah_ni
    assert ts.inst_s8 == js.inst_s8
    assert (tb.nodes == ts.bvh_nodes.numpy()).all()
    assert (tb.child_ids == ts.bvh_child_ids.numpy()).all()
    s8 = ts.inst_s8
    assert (tb.mt[:s8] == ts.bvh_mt.numpy()).all()
    assert (tb.mt[s8:] == 0).all()           # the tiles' padding leaves
    assert (tb.leaf_slot == ts.inst_leaf_slot.numpy()).all()
    assert (tb.leaf_xf == ts.inst_xf.numpy()).all()
    assert (np.asarray(js.bvh_remap) == ts.bvh_remap.numpy()).all()
    assert (np.asarray(js.inst_nmat) == ts.inst_nmat.numpy()).all()
    assert (np.asarray(js.shade_tbl) == ts.shade_tbl.numpy()).all()
    for f in ("scene_lo", "scene_hi", "sky_color", "mat_albedo",
              "mat_emissive"):
        assert (np.asarray(getattr(js, f)) == getattr(ts, f).numpy()).all()
    assert ts.num_triangles == js.num_triangles
    # the real depth (TLAS levels + the deepest local tree), in the
    # kernels' stack
    assert 2 <= ts.bvh_depth and 7 * ts.bvh_depth + 1 <= 64


def test_plain_itf_matches_traverse_packets5_interpret():
    """traverse5_plain in itf mode against the Pallas kernel it ports,
    on the JAX build's own tables: ids equal outside 1e-6-relative t
    ties, t rtol 1e-4, u/v atol 1e-4, t_init = t gives no hit, and
    inactive lanes are (0, -1, 0, 0)."""
    ih, ts, _, js = _pair(30)
    o, d = _rays(ih, 1024, 0)
    ref = _interp5(js.bvh_ctiles, js.bvh_ltiles, js.sah_ni, 8, jv3(o),
                   jv3(d), ldesc=js.inst_ldesc)
    tb = tables_from_tiles(np.asarray(js.bvh_ctiles),
                           np.asarray(js.bvh_ltiles), js.sah_ni,
                           np.asarray(js.inst_ldesc))
    args = (torch.from_numpy(tb.nodes), torch.from_numpy(tb.child_ids),
            torch.from_numpy(tb.mt), js.sah_ni, tv3(o), tv3(d))
    kw = dict(leaf_slot=torch.from_numpy(tb.leaf_slot),
              leaf_xf=torch.from_numpy(tb.leaf_xf))
    hit = traverse5_plain(*args, **kw)
    tri, rtri = hit.tri.numpy(), np.asarray(ref.tri)
    t, rt = hit.t.numpy(), np.asarray(ref.t)
    assert ((tri >= 0) == (rtri >= 0)).all()
    both = rtri >= 0
    assert 0.3 < both.mean() < 0.95
    tie = np.abs(t - rt) <= 1e-6 * np.abs(rt)
    assert not (both & (tri != rtri) & ~tie).any()
    np.testing.assert_allclose(t[both], rt[both], rtol=1e-4)
    same = both & (tri == rtri)
    np.testing.assert_allclose(hit.u.numpy()[same], np.asarray(ref.u)[same],
                               atol=1e-4)
    np.testing.assert_allclose(hit.v.numpy()[same], np.asarray(ref.v)[same],
                               atol=1e-4)
    assert (t[~both] == np.float32(3e38)).all()
    # the port's own tables give the same hits
    own = traverse5_plain(ts.bvh_nodes, ts.bvh_child_ids, ts.bvh_mt,
                          ts.sah_ni, tv3(o), tv3(d),
                          leaf_slot=ts.inst_leaf_slot, leaf_xf=ts.inst_xf)
    assert (own.tri == hit.tri).all() and (own.t == hit.t).all()
    # t_init chaining: nothing strictly closer than the found t
    again = traverse5_plain(*args, t_init=hit.t, **kw)
    assert (again.tri == -1).all() and (again.t == hit.t).all()
    active = torch.from_numpy(np.random.RandomState(1).rand(1024) < 0.5)
    part = traverse5_plain(*args, active=active, **kw)
    ina = ~active
    assert (part.t[ina] == 0).all() and (part.tri[ina] == -1).all()
    assert (part.u[ina] == 0).all() and (part.v[ina] == 0).all()
    assert (part.tri[active] == hit.tri[active]).all()
    assert (part.t[active] == hit.t[active]).all()


def test_instanced_shade_lanes_match_jax():
    ih, ts, _, js = _pair(30)
    o, d = _rays(ih, 2048, 2)
    hit = ttrace.intersect_scene(ts, tv3(o), tv3(d))
    ok = hit.tri.numpy() >= 0
    assert ok.mean() > 0.3
    inst = hit.tri.numpy()[ok] // ts.inst_s8
    assert len(np.unique(inst)) > 10      # many instances on screen
    n, uu, vv, mat = ttrace.shade_lanes(ts, hit)
    jhit = JHit(t=jnp.asarray(hit.t.numpy()),
                tri=jnp.asarray(hit.tri.numpy().astype(np.int32)),
                u=jnp.asarray(hit.u.numpy()), v=jnp.asarray(hit.v.numpy()))
    jn, juu, jvv, jmat = jtrace.shade_lanes(js, jhit)
    np.testing.assert_allclose(np3(n)[ok], np3(jn)[ok], rtol=0, atol=1e-6)
    np.testing.assert_allclose(uu.numpy()[ok], np.asarray(juu)[ok], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(vv.numpy()[ok], np.asarray(jvv)[ok], rtol=0,
                               atol=1e-6)
    for f in ("mtype", "tex", "rough", "ior"):
        assert (getattr(mat, f).numpy()[ok]
                == np.asarray(getattr(jmat, f))[ok]).all(), f
    for f in ("albedo", "emissive"):
        assert (np3(getattr(mat, f))[ok] == np3(getattr(jmat, f))[ok]).all()
    # world normals are unit and face every way the boxes do
    np.testing.assert_allclose(np.linalg.norm(np3(n)[ok], axis=1), 1.0,
                               atol=1e-5)


def test_instanced_render_matches_jax_baked():
    """The port's two-level render (traverse5_plain, itf) against the
    JAX package's render of the same scene baked, on the CPU: the
    flip-tolerant gate of tests/test_render.py, and per-bounce ray
    tallies within 0.5 % or 16 rays. 16 spp, because each flipped
    sample carries 1/spp of a pixel: at 4 spp the bright lamp's few
    flips alone (0.1 % of pixels) exceed the untrimmed ceiling, for the
    port's baked render as for its instanced one."""
    w = h = 64
    kw = dict(width=w, height=h, spp=16, max_depth=6, seed=0)
    ih, ts, jh, _ = _pair(30)
    cam = make_camera(w, h, ih.camera_position, ih.camera_direction,
                      ih.camera_focal_length, device="cpu")
    img, rays = render_wavefront(ts, cam, **kw)
    img, rays = img.numpy(), rays.numpy()
    jb = jh.bake()
    jimg, jrays = jrender(jbuild(jb, leaf_size=8),
                          jmake_camera(w, h, jb.camera_position,
                                       jb.camera_direction,
                                       jb.camera_focal_length), **kw)
    check_oracle_match(img, np.asarray(jimg))
    jrays = np.asarray(jrays).astype(np.int64)
    assert (np.abs(rays - jrays) <= np.maximum(16, 0.005 * jrays)).all(), (
        rays, jrays)
    assert rays[0] == w * h * 16 and rays[2] > 0
    assert img.mean() > 0.05


def test_instanced_tables_bytes_per_triangle():
    """At fixture scale the instanced device tables stay far below the
    baked scene's cost per world triangle."""
    glb = instanced_scene_glb(200)
    ih = load_glb_instanced(glb)
    ts = build_instanced_device_scene(ih, device="cpu")
    tables = (ts.bvh_nodes, ts.bvh_child_ids, ts.bvh_mt, ts.inst_leaf_slot,
              ts.inst_xf, ts.bvh_remap, ts.inst_nmat, ts.shade_tbl)
    nbytes = sum(t.numel() * t.element_size() for t in tables)
    per_tri = nbytes / ih.num_world_triangles
    assert per_tri < 200, per_tri
    baked = build_device_scene(ih.bake(), device="cpu")
    bbytes = sum(t.numel() * t.element_size() for t in (
        baked.bvh_nodes, baked.bvh_child_ids, baked.bvh_woop,
        baked.bvh_remap, baked.shade_tbl))
    assert nbytes < bbytes / 2


def test_entry_points_refuse_missing_cuda():
    """Without a device argument the entry points want the card, and
    raise on a machine without CUDA instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    ih = load_glb_instanced(instanced_scene_glb(4))
    for call in (lambda: build_instanced_device_scene(ih),
                 lambda: build_device_scene(ih.bake()),
                 lambda: make_camera(8, 8, ih.camera_position,
                                     ih.camera_direction, 1.0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cli_shared_instances_contract(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "inst.png"
    p = subprocess.run(
        [sys.executable, "-m", "sycl_ray_tracer_torch", "instanced_proc",
         "--shared-instances", "--device", "cpu", "-s", "1", "-d", "3",
         "--width", "32", "--height", "24", "-o", str(out)],
        cwd=root, env=dict(os.environ, PYTHONPATH=root),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.splitlines()
    assert re.fullmatch(r"Triangles: 12004 \(16 unique x 1002 instances\)",
                        next(ln for ln in lines
                             if ln.startswith("Triangles")))
    i = next(k for k, ln in enumerate(lines)
             if ln.startswith("Time measured"))
    assert re.fullmatch(r"Time measured: \d+\.\d{6} seconds", lines[i])
    m = re.fullmatch(r"Total rays: (\d+)", lines[i + 1])
    assert m and int(m.group(1)) >= 32 * 24
    assert re.fullmatch(r"Rays/sec: \d+\.\d\dM", lines[i + 2])
    assert out.stat().st_size > 0
