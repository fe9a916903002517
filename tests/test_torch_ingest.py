"""Port host side: GLB ingest, PNG codec, SAH build, Morton order and
Woop tables, identical to the JAX package's."""

import io
import sys

import numpy as np
import pytest
from PIL import Image

from sycl_ray_tracer_tpu.ops import sah as jsah
from sycl_ray_tracer_tpu.ops import wbvh as jwbvh
from sycl_ray_tracer_tpu.ops import woop as jwoop
from sycl_ray_tracer_tpu.utils import fixtures as jfix
from sycl_ray_tracer_tpu.utils import gltf as jgltf
from sycl_ray_tracer_tpu.utils import procgen as jproc
from sycl_ray_tracer_torch.models.scene import build_device_scene
from sycl_ray_tracer_torch.ops import sah as tsah
from sycl_ray_tracer_torch.ops import wbvh as twbvh
from sycl_ray_tracer_torch.ops import woop as twoop
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils import gltf as tgltf
from sycl_ray_tracer_torch.utils import procgen as tproc
from sycl_ray_tracer_torch.utils.png import decode_png, encode_png

from tests import torch_common  # noqa: F401  (thread count)

_SCENES = {
    "triangle": (jfix.triangle_scene_glb, tfix.triangle_scene_glb),
    "cube": (jfix.cube_scene_glb, tfix.cube_scene_glb),
    "textured": (jfix.textured_scene_glb, tfix.textured_scene_glb),
    "sponza1": (lambda: jproc.sponza_like_glb(scale=1),
                lambda: tproc.sponza_like_glb(scale=1)),
}
_CACHE = {}


def _hosts(name):
    """(JAX HostScene of the JAX-built GLB, port HostScene of the
    port-built GLB). The GLB bytes differ (PNG encoders differ); the
    decoded arrays must not."""
    if name not in _CACHE:
        jmake, tmake = _SCENES[name]
        _CACHE[name] = (jgltf.load_glb(jmake()), tgltf.load_glb(tmake()))
    return _CACHE[name]


_FIELDS = ("tri_v", "tri_n", "tri_uv", "tri_mat", "textures", "sky_color",
           "camera_position", "camera_direction")


@pytest.mark.parametrize("name", list(_SCENES))
def test_ingest_identical(name):
    jh, th = _hosts(name)
    for f in _FIELDS:
        a, b = getattr(jh, f), getattr(th, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert (a == b).all(), f
    assert jh.camera_focal_length == th.camera_focal_length
    for f in ("mtype", "albedo", "tex_id", "roughness", "ior", "emissive"):
        assert (getattr(jh.materials, f) == getattr(th.materials, f)).all()


def _pil_png(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    mode = "RGBA" if img.shape[2] == 4 else "RGB"
    Image.fromarray(img, mode).save(buf, format="PNG")
    return buf.getvalue()


def _png_filters(data: bytes):
    """Row filter types used by a PNG (8-bit, RGB/RGBA)."""
    import struct
    import zlib
    off, idat, hdr = 8, [], None
    while off < len(data):
        n, kind = struct.unpack_from(">I4s", data, off)
        body = data[off + 8: off + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        off += 12 + n
    w, h, _, ctype, _, _, _ = hdr
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


def test_png_decode_matches_pil_all_filters():
    rs = np.random.RandomState(0)
    seen = set()
    for c in (3, 4):
        noise = rs.randint(0, 256, (37, 53, c), dtype=np.uint8)
        yy, xx = np.mgrid[0:37, 0:53]
        ramp = np.stack([(xx * 5 + yy * 3) % 256] * c, -1).astype(np.uint8)
        for img in (noise, ramp, (noise // 64) * 64):
            data = _pil_png(img)
            seen |= _png_filters(data)
            out = decode_png(data)
            assert (out == img).all()
    # PIL's adaptive filtering exercised the sequential filters too
    assert {3, 4} & seen


def test_png_encode_roundtrip_through_pil():
    rs = np.random.RandomState(1)
    for c in (3, 4):
        img = rs.randint(0, 256, (19, 23, c), dtype=np.uint8)
        data = encode_png(img)
        assert (decode_png(data) == img).all()
        with Image.open(io.BytesIO(data)) as im:
            assert (np.asarray(im) == img).all()


def test_texture_texels_identical_to_pil_decode():
    _, th = _hosts("sponza1")
    glb = tproc.sponza_like_glb(scale=1)
    gltf, blob = jgltf._parse_glb_container(glb)
    for i, im in enumerate(gltf["images"]):
        view = gltf["bufferViews"][im["bufferView"]]
        raw = blob[view.get("byteOffset", 0):][:view["byteLength"]]
        with Image.open(io.BytesIO(raw)) as pil:
            ref = np.asarray(pil.convert("RGBA"))
        assert (th.textures[i] == ref).all()


@pytest.mark.parametrize("name", ["cube", "sponza1"])
def test_sah_morton_and_woop_identical(name):
    jh, th = _hosts(name)
    jb = jsah.build_sah(jh.tri_v, 8)
    tb = tsah.build_sah(th.tri_v, 8)
    for f in ("children", "child_ids", "order"):
        assert (getattr(jb, f) == getattr(tb, f)).all(), f
    assert (jb.num_internal, jb.num_leaves, jb.depth) == (
        tb.num_internal, tb.num_leaves, tb.depth)
    jrows = jsah.leaf_rows(jh.tri_v, jb.order, 8)
    trows = tsah.leaf_rows(th.tri_v, tb.order, 8)
    assert (jrows == trows).all()
    for a, b in zip(jwoop.woop_from_leaf_rows(jrows),
                    twoop.woop_from_leaf_rows(trows)):
        assert (a == b).all()
    jorder = jwbvh.build_np(jh.tri_v, 8)[0].order
    assert (np.asarray(jorder) == twbvh.morton_order(th.tri_v, 8)).all()


def test_device_scene_tables_match_jax():
    from sycl_ray_tracer_tpu.models.scene import build_device_scene as jbuild

    jh, th = _hosts("sponza1")
    js = jbuild(jh, leaf_size=8)
    ts = build_device_scene(th, device="cpu")
    assert js.has_sah and ts.sah_ni == js.sah_ni
    assert (np.asarray(js.bvh_remap) == ts.bvh_remap.numpy()).all()
    assert (np.asarray(js.shade_tbl) == ts.shade_tbl.numpy()).all()
    tex = ts.tex_packed.numpy().view(np.uint32)
    assert (np.asarray(js.tex_packed) == tex).all()
    for f in ("sky_color", "scene_lo", "scene_hi", "mat_albedo",
              "mat_rough", "mat_ior", "mat_emissive"):
        assert (np.asarray(getattr(js, f)) == getattr(ts, f).numpy()).all()
    assert (np.asarray(js.mat_type) == ts.mat_type.numpy()).all()
    assert (np.asarray(js.mat_tex) == ts.mat_tex.numpy()).all()
    assert ts.has_textures == js.has_textures
    # woop records: M row-major then tr, per SAH slot
    M, tr, _ = twoop.woop_from_leaf_rows(
        tsah.leaf_rows(th.tri_v, tsah.build_sah(th.tri_v, 8).order, 8))
    w = ts.bvh_woop.numpy()
    assert (w[:, :9] == M.reshape(-1, 9)).all()
    assert (w[:, 9:] == tr.reshape(-1, 3)).all()


def test_stack_bound_matches_header():
    import os
    import re

    from sycl_ray_tracer_torch.ops import kernels

    with open(os.path.join(kernels.CSRC, "bvh8_walk.cuh")) as f:
        m = re.search(r"#define SRT_STACK (\d+)", f.read())
    assert int(m.group(1)) == kernels.STACK
    _, th = _hosts("sponza1")
    ts = build_device_scene(th, device="cpu")
    assert 7 * ts.bvh_depth + 1 <= kernels.STACK


_RESIZE_SHAPES = [(256, 256), (1024, 1024), (300, 700), (513, 40)]


@pytest.mark.parametrize("h,w", _RESIZE_SHAPES)
def test_resample_bilinear_equals_pillow(h, w):
    """The numpy resample against Pillow's mode-F BILINEAR resize to
    512x512, bit for bit, on random float32 images."""
    a = np.random.RandomState(h * 7 + w).rand(h, w).astype(np.float32)
    ref = np.asarray(Image.fromarray(a, "F").resize(
        (tgltf.TEX_RES, tgltf.TEX_RES), Image.BILINEAR), np.float32)
    got = tgltf.resample_bilinear(a, tgltf.TEX_RES, tgltf.TEX_RES)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("h,w", _RESIZE_SHAPES)
def test_decode_image_bytes_equals_jax_without_pil(monkeypatch, h, w,
                                                   channels):
    """PNGs that need the resize decode byte-equal to the JAX package's
    Pillow path, with every import of PIL refused on the port's side."""
    img = tfix._resize_texture(w, h, channels, seed=h + w)
    for png in (encode_png(img), _pil_png(img)):
        ref = jgltf.decode_image_bytes(png)
        monkeypatch.setitem(sys.modules, "PIL", None)
        got = tgltf.decode_image_bytes(png)
        monkeypatch.undo()
        assert got.dtype == np.uint8 and got.shape == ref.shape
        assert np.array_equal(got, ref)


def test_non_png_texture_names_pillow(monkeypatch):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="JPEG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(NotImplementedError, match="image 2.*needs Pillow"):
        tgltf.decode_image_bytes(buf.getvalue(), "image 2")


def test_resized_textures_pinned():
    """The fixture's decoded textures: the port's equal the Pillow path's,
    and both equal the digests that chip_smoke.py checks on the card."""
    import hashlib

    glb = tfix.resized_textures_glb()
    ref = jgltf.load_glb(glb).textures
    got = tgltf.load_glb(glb).textures
    assert np.array_equal(got, ref)
    assert tuple(hashlib.sha256(t.tobytes()).hexdigest()
                 for t in ref) == tfix.RESIZED_TEXTURES_SHA256


_SCALE = (2.0, 0.5, 3.0)


@pytest.mark.parametrize("name", ["cube", "resized", "instanced"])
def test_global_scale_equals_jax(name):
    """load_glb and load_glb_instanced at global_scale (2, 0.5, 3): the
    port's host scenes equal the JAX package's bit for bit (vertices,
    normals, camera), and the instanced world matrices carry the scale
    as JAX applies it."""
    from sycl_ray_tracer_tpu.utils import instanced as jinst
    from sycl_ray_tracer_torch.utils import instanced as tinst

    glb = {"cube": tfix.cube_scene_glb, "resized": tfix.resized_textures_glb,
           "instanced": lambda: tfix.instanced_scene_glb(30)}[name]()
    jh = jgltf.load_glb(glb, global_scale=_SCALE)
    th = tgltf.load_glb(glb, global_scale=_SCALE)
    for f in _FIELDS:
        assert np.array_equal(getattr(jh, f), getattr(th, f)), f
    assert jh.camera_focal_length == th.camera_focal_length
    assert not np.array_equal(th.tri_v, tgltf.load_glb(glb).tri_v)
    ji = jinst.load_glb_instanced(glb, global_scale=_SCALE)
    ti = tinst.load_glb_instanced(glb, global_scale=_SCALE)
    assert np.array_equal(ji.inst_mat, ti.inst_mat)
    assert np.array_equal(ji.inst_prim, ti.inst_prim)
    for f in ("camera_position", "camera_direction", "textures"):
        assert np.array_equal(getattr(ji, f), getattr(ti, f)), f
    baked = ti.bake()
    for f in ("tri_v", "tri_n"):
        assert np.array_equal(getattr(baked, f), getattr(th, f)), f


# ---- the Python ingest: load_glb(use_native=False) ----

_PY_SCENES = {
    "triangle": (tfix.triangle_scene_glb, (1.0, 1.0, 1.0)),
    "cube": (tfix.cube_scene_glb, (1.0, 1.0, 1.0)),
    "dielectric": (lambda: tfix.dielectric_scene_glb(subdiv=1),
                   (1.0, 1.0, 1.0)),
    "textured": (tfix.textured_scene_glb, (1.0, 1.0, 1.0)),
    "resized": (tfix.resized_textures_glb, (1.0, 1.0, 1.0)),
    "instanced": (lambda: tfix.instanced_scene_glb(30), (1.0, 1.0, 1.0)),
    "sponza1": (lambda: tproc.sponza_like_glb(scale=1), (1.0, 1.0, 1.0)),
    "cube-scaled": (tfix.cube_scene_glb, (2.0, 0.5, 1.0)),
}


def _equal_hosts(a, b):
    """Two HostScenes equal bit for bit, dtypes included."""
    for f in _FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.camera_focal_length == b.camera_focal_length
    for f in ("mtype", "albedo", "tex_id", "roughness", "ior", "emissive"):
        x, y = getattr(a.materials, f), getattr(b.materials, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("name", list(_PY_SCENES))
def test_python_ingest_equals_jax_python_ingest(name):
    """The port's Python ingest against the JAX package's on the same
    GLB bytes, bit for bit (the same numpy code), and against the port's
    native ingest under tests/test_native.py's tolerances."""
    make, scale = _PY_SCENES[name]
    glb = make()
    py = tgltf.load_glb(glb, scale, use_native=False)
    _equal_hosts(jgltf.load_glb(glb, scale, use_native=False), py)
    assert not tgltf.ingest_mismatch(tgltf.load_glb(glb, scale), py)


def _malformed(case):
    """The malformed GLBs of tests/test_native.py:128-205 and :63."""
    import json
    import struct

    from tests.test_native import _mk_glb, _tri_gltf

    g, bin_ = _tri_gltf()
    if case == "overflow-stride":
        g["bufferViews"][0]["byteStride"] = 1 << 52
        g["accessors"][0]["count"] = 4097
    elif case == "huge-count":
        g["accessors"].append({"componentType": 5125, "count": int(1e15),
                               "type": "SCALAR"})
        g["meshes"][0]["primitives"][0]["indices"] = 1
    elif case == "truncated-number":
        j = json.dumps(g).encode()
        cut = j[: j.rindex(b"0") + 1]
        chunks = struct.pack("<II", len(cut), 0x4E4F534A) + cut
        chunks += struct.pack("<II", 8, 0x004E4942) + b"12345678"
        return b"glTF" + struct.pack("<II", 2, 12 + len(chunks)) + chunks
    elif case == "cyclic":
        g["nodes"] = [{"children": [1]}, {"children": [0], "mesh": 0}]
    elif case == "truncated-bin":
        full = tfix.cube_scene_glb()
        return full[: len(full) - 256]
    elif case == "stride-zero":
        g["bufferViews"][0]["byteStride"] = 0
    elif case == "sky-len2":
        g["scenes"][0]["extras"] = {"sky_color": [9.0, 9.0]}
    elif case == "zero-scale":
        n = np.array([[0, 0, 1]] * 3, np.float32)
        bin_ = bin_ + n.tobytes()
        g["buffers"] = [{"byteLength": len(bin_)}]
        g["bufferViews"] = [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 36}]
        g["accessors"].append({"bufferView": 1, "componentType": 5126,
                               "count": 3, "type": "VEC3"})
        g["meshes"][0]["primitives"][0]["attributes"]["NORMAL"] = 1
        g["nodes"] = [{"mesh": 0, "scale": [1.0, 0.0, 1.0]}]
    return _mk_glb(g, bin_)


_RAISING = ("overflow-stride", "huge-count", "truncated-number", "cyclic",
            "truncated-bin")


@pytest.mark.parametrize("case", _RAISING + ("stride-zero", "sky-len2",
                                             "zero-scale"))
def test_python_ingest_malformed_inputs(case):
    """Through the Python path each malformed file raises what the JAX
    package's Python path raises (a 4 PB zero-filled index accessor asks
    numpy for the array, which refuses it: MemoryError), and the native
    path raises ValueError; where the file is only odd, both Python paths
    load it bit for bit alike and the native one agrees."""
    data = _malformed(case)
    if case in _RAISING:
        with pytest.raises(Exception) as jerr:
            jgltf.load_glb(data, use_native=False)
        with pytest.raises(type(jerr.value)):
            tgltf.load_glb(data, use_native=False)
        with pytest.raises(ValueError):
            tgltf.load_glb(data)
        return
    py = tgltf.load_glb(data, use_native=False)
    _equal_hosts(jgltf.load_glb(data, use_native=False), py)
    nat = tgltf.load_glb(data)
    assert not tgltf.ingest_mismatch(nat, py)
    if case == "stride-zero":
        assert py.num_triangles == 1
        assert not np.allclose(py.tri_v[0, 0], py.tri_v[0, 1])
    elif case == "sky-len2":
        assert py.sky_color.shape == (3,)
        assert np.allclose(py.sky_color, (0.5, 0.7, 1.0))
    else:
        assert (py.tri_n == 0).all() and (nat.tri_n == py.tri_n).all()


def test_load_glb_has_no_fallback(monkeypatch):
    """The default ingest is native and raises when the native library
    fails; use_native=False never touches the library."""
    from sycl_ray_tracer_torch.utils import native_loader

    glb = tfix.cube_scene_glb()

    def broken(*a, **k):
        raise RuntimeError("building the native library failed")

    monkeypatch.setattr(native_loader, "load_glb_native", broken)
    monkeypatch.setattr(native_loader, "load_library", broken)
    with pytest.raises(RuntimeError, match="native library"):
        tgltf.load_glb(glb)
    with pytest.raises(RuntimeError, match="native library"):
        tgltf.load_glb(glb, use_native=True)
    assert tgltf.load_glb(glb, use_native=False).num_triangles > 0
