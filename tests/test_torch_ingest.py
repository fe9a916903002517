"""Port host side: GLB ingest, PNG codec, SAH build, Morton order and
Woop tables, identical to the JAX package's."""

import io

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
    assert (np.asarray(jorder) == twbvh.build_np(th.tri_v, 8)).all()


def test_device_scene_tables_match_jax():
    from sycl_ray_tracer_tpu.models.scene import build_device_scene as jbuild

    jh, th = _hosts("sponza1")
    js = jbuild(jh, leaf_size=8)
    ts = build_device_scene(th)
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

    from sycl_ray_tracer_torch.ops import traverse8 as t8

    with open(os.path.join(t8.CSRC, "traverse8.cuh")) as f:
        m = re.search(r"#define SRT_STACK (\d+)", f.read())
    assert int(m.group(1)) == t8.STACK
    _, th = _hosts("sponza1")
    ts = build_device_scene(th)
    assert 7 * ts.bvh_depth + 1 <= t8.STACK
