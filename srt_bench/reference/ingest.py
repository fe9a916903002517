"""The reference's own reading of a .glb: plain numpy, every instance
baked to world space.

It reads the GLB bytes that the benchmark generated, never the port's
tables. The rules are those of the upstream renderer's scene.cpp, as
the port's Python ingest applies them:

- node world matrices compose parent @ local (TRS or an explicit
  matrix); vertices go through the node's matrix, normals through the
  inverse transpose of its 3x3 part;
- a primitive without a material takes a default diffuse 0.8, placed
  after the file's materials;
- dielectric iff KHR_materials_ior and KHR_materials_transmission,
  else metallic iff metallicFactor > 0.01, else diffuse; a dielectric
  never emits; emission is emissiveFactor times
  KHR_materials_emissive_strength (0 without it);
- the sky is scene.extras.sky_color times sky_strength, (0.5, 0.7, 1.0)
  by default;
- the camera is the first camera node met in a depth-first walk of the
  scene's nodes: its translation, its rotation applied to (0, 0, -1),
  and a focal length of 1 / tan(yfov / 2);
- textures are 8-bit RGBA images, read as bytes / 255 with no sRGB
  decode; an image of another size is first resized to TEX_RES x
  TEX_RES as upstream's image manager does (stbir's sRGB resize): the
  colour channels taken to linear light, each channel filtered apart,
  alpha as it is, and the colours taken back to sRGB and rounded. The
  filter is the one the port states, Pillow's bilinear resize: a
  triangle of half-width one output texel, over the input's texels,
  with weights normalised over the taps that fall inside the image.

Instances of one mesh are transformed together, one batch per mesh,
which keeps a scene of 170,000 instances within a second or two.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np

from srt_bench.scenes.png import decode_png

GLB_MAGIC = 0x46546C67
CHUNK_JSON = 0x4E4F534A
CHUNK_BIN = 0x004E4942
TEX_RES = 512
MAX_IMAGES = 128
MAT_DIFFUSE, MAT_METALLIC, MAT_DIELECTRIC = 0, 1, 2
DEFAULT_SKY = (0.5, 0.7, 1.0)

_DTYPES = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
           5125: np.uint32, 5126: np.float32}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT3": 9,
          "MAT4": 16}


@dataclasses.dataclass
class RefScene:
    """A baked world-space scene in numpy arrays."""

    tri_v: np.ndarray      # [N, 3, 3] f32 positions
    tri_n: np.ndarray      # [N, 3, 3] f32 unit vertex normals
    tri_uv: np.ndarray     # [N, 3, 2] f32
    tri_mat: np.ndarray    # [N] int64 material ids
    mtype: np.ndarray      # [M] int64
    albedo: np.ndarray     # [M, 3] f32
    tex_id: np.ndarray     # [M] int64, -1 for a solid color
    rough: np.ndarray      # [M] f32
    ior: np.ndarray        # [M] f32
    emissive: np.ndarray   # [M, 3] f32
    textures: np.ndarray   # [T, TEX_RES, TEX_RES, 4] uint8
    sky: np.ndarray        # [3] f32
    cam_pos: np.ndarray    # [3] f64
    cam_dir: np.ndarray    # [3] f64, unit
    focal: float


def _container(data: bytes):
    magic, version, length = struct.unpack_from("<III", data, 0)
    if magic != GLB_MAGIC or version != 2:
        raise ValueError("not a version 2 GLB")
    off, gltf, blob = 12, None, b""
    while off + 8 <= min(length, len(data)):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8:off + 8 + clen]
        off += 8 + clen
        if ctype == CHUNK_JSON and gltf is None:
            gltf = json.loads(chunk)
        elif ctype == CHUNK_BIN and not blob:
            blob = chunk
    if gltf is None:
        raise ValueError("GLB without a JSON chunk")
    return gltf, blob


def _accessor(gltf, blob, index) -> np.ndarray:
    acc = gltf["accessors"][index]
    ncomp, dtype = _NCOMP[acc["type"]], _DTYPES[acc["componentType"]]
    count = acc["count"]
    if "bufferView" not in acc:
        return np.zeros((count, ncomp), dtype)
    view = gltf["bufferViews"][acc["bufferView"]]
    base = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    tight = ncomp * np.dtype(dtype).itemsize
    stride = view.get("byteStride", 0) or tight
    raw = np.frombuffer(blob, np.uint8, count=stride * (count - 1) + tight,
                        offset=base)
    rows = np.lib.stride_tricks.as_strided(raw, (count, tight), (stride, 1))
    return rows.copy().view(dtype).reshape(count, ncomp)


def _local(node) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(np.asarray(node["scale"], np.float64))
    if "rotation" in node:
        x, y, z, w = (float(c) for c in node["rotation"])
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = np.asarray(node["translation"], np.float64)
    return m


def _materials(gltf):
    mats = list(gltf.get("materials", [])) + [{"pbrMetallicRoughness": {
        "baseColorFactor": [0.8, 0.8, 0.8, 1.0], "metallicFactor": 0.0}}]
    m = len(mats)
    mtype = np.zeros(m, np.int64)
    albedo = np.ones((m, 3), np.float32)
    tex_id = np.full(m, -1, np.int64)
    rough = np.zeros(m, np.float32)
    ior = np.full(m, 1.5, np.float32)
    emissive = np.zeros((m, 3), np.float32)
    textures = gltf.get("textures", [])
    for i, mat in enumerate(mats):
        pbr = mat.get("pbrMetallicRoughness", {})
        ext = mat.get("extensions", {})
        strength = float(ext.get("KHR_materials_emissive_strength", {}).get(
            "emissiveStrength", 1.0)) if (
            "KHR_materials_emissive_strength" in ext) else 0.0
        emissive[i] = np.asarray(mat.get("emissiveFactor", [0.0, 0.0, 0.0]),
                                 np.float32) * strength
        bct = pbr.get("baseColorTexture")
        tex = (int(textures[bct["index"]].get("source", -1))
               if bct is not None and bct.get("index", -1) > -1 else -1)
        if "KHR_materials_ior" in ext and "KHR_materials_transmission" in ext:
            mtype[i] = MAT_DIELECTRIC
            ior[i] = float(ext["KHR_materials_ior"].get("ior", 1.5))
            emissive[i] = 0.0
            continue
        if float(pbr.get("metallicFactor", 1.0)) > 0.01:
            mtype[i] = MAT_METALLIC
            rough[i] = float(pbr.get("roughnessFactor", 1.0))
        albedo[i] = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])[:3]
        tex_id[i] = tex
    return mtype, albedo, tex_id, rough, ior, emissive


def _taps(n_in: int, n_out: int):
    """(first tap, weights [n_out, k]) of the triangle filter that
    resamples an axis of n_in texels to n_out: output texel i centred
    at (i + 0.5) * n_in / n_out on the input, with a half-width of
    max(n_in / n_out, 1) input texels."""
    scale = n_in / n_out
    width = max(scale, 1.0)
    k = int(np.ceil(width)) * 2 + 1
    first = np.zeros(n_out, np.int64)
    w = np.zeros((n_out, k), np.float64)
    for i in range(n_out):
        centre = (i + 0.5) * scale
        lo = max(int(centre - width + 0.5), 0)
        hi = min(int(centre + width + 0.5), n_in)
        x = (np.arange(lo, hi) - centre + 0.5) / width
        t = np.maximum(0.0, 1.0 - np.abs(x))
        w[i, :hi - lo] = t / t.sum() if t.sum() != 0 else t
        first[i] = lo
    return first, w


def _filter_axis(a: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """Resample one axis of a float32 image, summed in float64 tap by
    tap and stored as float32; an axis of the right size is kept."""
    if a.shape[axis] == n_out:
        return a
    first, w = _taps(a.shape[axis], n_out)
    a = np.moveaxis(a, axis, 0)
    acc = np.zeros((n_out,) + a.shape[1:], np.float64)
    for j in range(w.shape[1]):
        idx = np.minimum(first + j, a.shape[0] - 1)
        wj = w[:, j].reshape((n_out,) + (1,) * (a.ndim - 1))
        acc += a[idx].astype(np.float64) * wj
    return np.moveaxis(acc.astype(np.float32), 0, axis)


def _resize(px: np.ndarray) -> np.ndarray:
    """[H, W, 4] uint8 -> [TEX_RES, TEX_RES, 4] uint8, the sRGB-aware
    resize above (columns first, then rows)."""
    a = px.astype(np.float32) / np.float32(255.0)
    c = a[..., :3]
    lin = np.where(c <= 0.04045, c / np.float32(12.92),
                   ((c + np.float32(0.055)) / np.float32(1.055))
                   ** np.float32(2.4)).astype(np.float32)
    planes = [lin[..., 0], lin[..., 1], lin[..., 2], a[..., 3]]
    out = np.stack([_filter_axis(_filter_axis(p, TEX_RES, 1), TEX_RES, 0)
                    for p in planes], axis=-1)
    c = np.clip(out[..., :3], 0.0, 1.0)
    srgb = np.where(c <= 0.0031308, c * np.float32(12.92),
                    np.float32(1.055) * c ** np.float32(1 / 2.4)
                    - np.float32(0.055))
    out = np.concatenate([srgb, out[..., 3:]], axis=-1)
    return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)


def _textures(gltf, blob) -> np.ndarray:
    out = []
    for image in gltf.get("images", [])[:MAX_IMAGES]:
        view = gltf["bufferViews"][image["bufferView"]]
        base = view.get("byteOffset", 0)
        px = decode_png(blob[base:base + view["byteLength"]])
        if px.shape[2] == 3:
            px = np.concatenate([px, np.full(px.shape[:2] + (1,), 255,
                                             np.uint8)], -1)
        out.append(px if px.shape[:2] == (TEX_RES, TEX_RES)
                   else _resize(px))
    if not out:
        return np.zeros((1, TEX_RES, TEX_RES, 4), np.uint8)
    return np.stack(out)


def load(data: bytes) -> RefScene:
    gltf, blob = _container(data)
    scenes = gltf.get("scenes", [{}])
    scene = scenes[gltf.get("scene", 0)]
    extras = scene.get("extras", {})
    sky = np.asarray(extras.get("sky_color", DEFAULT_SKY), np.float32)[:3]
    if "sky_strength" in extras:
        sky = sky * np.float32(extras["sky_strength"])
    nodes = gltf.get("nodes", [])

    world, order = {}, []

    def visit(idx, parent):
        m = parent @ _local(nodes[idx])
        world[idx] = m
        order.append(idx)
        for child in nodes[idx].get("children", []):
            visit(child, m)

    for root in scene.get("nodes", []):
        visit(root, np.eye(4))

    mtype, albedo, tex_id, rough, ior, emissive = _materials(gltf)
    default_mat = len(mtype) - 1
    by_mesh, cam_node = {}, None
    for idx in order:
        if "camera" in nodes[idx] and cam_node is None:
            cam_node = idx
        if "mesh" in nodes[idx]:
            by_mesh.setdefault(nodes[idx]["mesh"], []).append(idx)

    parts = []  # (first node's position in `order`, v, n, uv, mat)
    rank = {idx: i for i, idx in enumerate(order)}
    for mesh, idxs in by_mesh.items():
        mats = np.stack([world[i] for i in idxs])           # [I, 4, 4]
        m3 = mats[:, :3, :3]
        nm = np.linalg.inv(m3).transpose(0, 2, 1)           # normal matrix
        for prim in gltf["meshes"][mesh].get("primitives", []):
            attrs = prim["attributes"]
            pos = _accessor(gltf, blob, attrs["POSITION"]).astype(np.float64)
            tri = (_accessor(gltf, blob, prim["indices"]).reshape(-1)
                   .astype(np.int64) if "indices" in prim
                   else np.arange(pos.shape[0]))
            nrm = _accessor(gltf, blob, attrs["NORMAL"]).astype(np.float64)
            uv = (_accessor(gltf, blob, attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs
                  else np.zeros((pos.shape[0], 2), np.float32))
            wp = np.einsum("nij,pj->npi", m3, pos) + mats[:, None, :3, 3]
            wn = np.einsum("nij,pj->npi", nm, nrm)
            mat = prim.get("material", -1)
            mat = mat if mat >= 0 else default_mat
            for k, i in enumerate(idxs):
                parts.append((rank[i], wp[k][tri], wn[k][tri], uv[tri], mat))
    parts.sort(key=lambda p: p[0])
    tri_v = np.concatenate([p[1] for p in parts]).reshape(-1, 3, 3)
    tri_n = np.concatenate([p[2] for p in parts]).reshape(-1, 3, 3)
    tri_n = tri_n / np.maximum(np.linalg.norm(tri_n, axis=-1, keepdims=True),
                               1e-20)
    tri_uv = np.concatenate([p[3] for p in parts]).reshape(-1, 3, 2)
    tri_mat = np.concatenate([np.full(p[1].shape[0] // 3, p[4], np.int64)
                              for p in parts])

    if cam_node is None:
        raise ValueError("the reference needs a camera node")
    m = world[cam_node]
    r = m[:3, :3] / np.maximum(np.linalg.norm(m[:3, :3], axis=0,
                                              keepdims=True), 1e-20)
    cam_dir = r @ np.array([0.0, 0.0, -1.0])
    cam_dir = cam_dir / max(np.linalg.norm(cam_dir), 1e-20)
    persp = gltf["cameras"][nodes[cam_node]["camera"]].get("perspective", {})
    focal = 1.0 / np.tan(float(persp.get("yfov", np.deg2rad(45.0))) / 2.0)
    return RefScene(
        tri_v=tri_v.astype(np.float32), tri_n=tri_n.astype(np.float32),
        tri_uv=tri_uv, tri_mat=tri_mat, mtype=mtype, albedo=albedo,
        tex_id=tex_id, rough=rough, ior=ior, emissive=emissive,
        textures=_textures(gltf, blob), sky=sky.astype(np.float32),
        cam_pos=m[:3, 3].astype(np.float32).astype(np.float64),
        cam_dir=cam_dir.astype(np.float32).astype(np.float64),
        focal=float(focal))
