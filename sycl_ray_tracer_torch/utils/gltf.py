"""Binary glTF (.glb) ingest -> flat host-side scene arrays.

Replaces the reference's tiny_gltf + Embree instancing pipeline
(scene.cpp:54-510). By default the GLB container, accessors, node
transforms and material classification are parsed by the shared native
core (native/srt_native.cpp, through utils/native_loader.py), which the
SAH build needs anyway. load_glb(..., use_native=False) parses the same
file in Python instead (the JAX package's pure-Python ingest, the
same numpy code): a second, independent reading of a scene that judges
the native one. The glTF helpers here also serve the two-level ingest
(utils/instanced.py). Differences from the reference by design:

- Instancing is *baked*: every (node, primitive) instance's vertices are
  transformed to world space at load (the reference instead builds
  Embree BLAS-per-primitive + TLAS-of-instances, scene.cpp:404-439,
  487-507, and transforms in-kernel).
- Embedded PNG textures are decoded by utils/png.py (stdlib + numpy)
  and resized to TEX_RES x TEX_RES by resample_bilinear (numpy, equal
  to Pillow's resize); an imaging library is needed only to decode
  another format.

- A primitive without a material gets a default diffuse(0.8) instead
  of tripping an assert (scene.cpp:176); a scene without a camera node
  gets a bbox-framing default camera (the reference reads nodes[-1],
  scene.cpp:109); missing NORMAL/TEXCOORD_0 fall back to geometric
  normals / zero UVs (scene.cpp:260-276).

Material classification (scene.cpp:188-254):
  dielectric  iff KHR_materials_ior AND KHR_materials_transmission
  else metallic iff pbr.metallicFactor > 0.01
  else diffuse
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

GLB_MAGIC = 0x46546C67
CHUNK_JSON = 0x4E4F534A
CHUNK_BIN = 0x004E4942

# Fixed texture-atlas resolution, matching the reference's ImageManager
# (image_manager.hpp:12-14: 512x512 RGBA, at most 128 images).
TEX_RES = 512

MAT_DIFFUSE = 0
MAT_METALLIC = 1
MAT_DIELECTRIC = 2

MAX_IMAGES = 128
DEFAULT_SKY = (0.5, 0.7, 1.0)  # scene.hpp default sky_color

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COMPONENTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT3": 9,
    "MAT4": 16,
}


@dataclasses.dataclass
class HostMaterialTable:
    """SoA material table (tagged union -> parallel arrays)."""

    mtype: np.ndarray      # [M] uint8  (MAT_*)
    albedo: np.ndarray     # [M, 3] float32 (solid color / baseColorFactor)
    tex_id: np.ndarray     # [M] int32, -1 = solid color
    roughness: np.ndarray  # [M] float32 (metallic only)
    ior: np.ndarray        # [M] float32 (dielectric only)
    emissive: np.ndarray   # [M, 3] float32


@dataclasses.dataclass
class HostScene:
    """Flat world-space scene, ready for device upload."""

    # Geometry, SoA over triangles. v0/v1/v2 world-space positions.
    tri_v: np.ndarray       # [N, 3, 3] float32 (tri, vertex, xyz)
    tri_n: np.ndarray       # [N, 3, 3] float32 shading normals (unnormalized)
    tri_uv: np.ndarray      # [N, 3, 2] float32
    tri_mat: np.ndarray     # [N] int32 material index
    materials: HostMaterialTable
    textures: np.ndarray    # [T, TEX_RES, TEX_RES, 4] uint8 (T >= 1)
    sky_color: np.ndarray   # [3] float32 (already scaled by sky_strength)
    camera_position: np.ndarray   # [3] float32
    camera_direction: np.ndarray  # [3] float32 (normalized)
    camera_focal_length: float

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v.shape[0])


def _bilinear_taps(n_in: int, n_out: int):
    """Pillow's precompute_coeffs for the BILINEAR filter along one axis:
    (first input index [n_out], tap count [n_out], weights [n_out, K]
    float64, zero past each count)."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    support = 1.0 * fs
    ss = 1.0 / fs
    k = int(np.ceil(support)) * 2 + 1
    first = np.empty(n_out, np.int64)
    count = np.empty(n_out, np.int64)
    w = np.zeros((n_out, k), np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        m = min(int(center + support + 0.5), n_in) - lo
        x = np.arange(m, dtype=np.float64)
        wi = np.maximum(1.0 - np.abs((x + lo - center + 0.5) * ss), 0.0)
        total = 0.0
        for v in wi:      # summed in order, as Pillow does
            total += v
        first[i], count[i] = lo, m
        w[i, :m] = wi / total if total != 0.0 else wi
    return first, count, w


def _resample_axis(a: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One pass of Pillow's separable resample of a float32 image along
    `axis`: each output sums its taps in float64, in order, and is
    stored as float32."""
    first, count, w = _bilinear_taps(a.shape[axis], n_out)
    a = np.moveaxis(a, axis, 0)
    acc = np.zeros((n_out,) + a.shape[1:], np.float64)
    shape = (n_out,) + (1,) * (a.ndim - 1)
    for j in range(w.shape[1]):
        idx = np.minimum(first + j, a.shape[0] - 1)
        tap = a[idx].astype(np.float64) * w[:, j].reshape(shape)
        acc = np.where((j < count).reshape(shape), acc + tap, acc)
    return np.moveaxis(acc.astype(np.float32), 0, axis)


def resample_bilinear(a: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """[H, W] float32 -> [out_h, out_w] float32, equal bit for bit to
    Pillow's Image.fromarray(a, "F").resize((out_w, out_h), BILINEAR):
    the horizontal pass first, then the vertical pass over its float32
    rows; an axis whose size does not change is not resampled."""
    out = np.asarray(a, np.float32)
    if out.shape[1] != out_w:
        out = _resample_axis(out, out_w, 1)
    if out.shape[0] != out_h:
        out = _resample_axis(out, out_h, 0)
    return out


def decode_image_bytes(raw: bytes, name: str = "image") -> np.ndarray:
    """Decode encoded image bytes to TEX_RES x TEX_RES RGBA uint8.

    An 8-bit RGB/RGBA PNG decodes through utils/png.py. Any size other
    than TEX_RES x TEX_RES goes through an sRGB-AWARE resize, mirroring
    the reference's stbir_resize_uint8_srgb (image_manager.hpp:51-61):
    color channels are converted to linear, filtered there with
    resample_bilinear, and re-encoded; alpha is filtered linearly as-is.
    Only formats other than PNG, and PNG variants utils/png.py refuses,
    need Pillow; without it they raise NotImplementedError."""
    px = None
    if raw[:8] == b"\x89PNG\r\n\x1a\n":
        from sycl_ray_tracer_torch.utils.png import decode_png

        try:
            px = decode_png(raw)
        except ValueError:
            px = None  # a PNG variant the stdlib decoder does not cover
    if px is None:
        try:
            from PIL import Image
        except ImportError:
            raise NotImplementedError(
                f"{name}: this texture is not an 8-bit RGB/RGBA PNG; "
                f"decoding other formats and PNG variants needs Pillow, "
                f"which is not installed") from None
        px = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"),
                        np.uint8)
    if px.shape[2] == 3:
        px = np.concatenate(
            [px, np.full(px.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    if px.shape[:2] == (TEX_RES, TEX_RES):
        return px
    a = px.astype(np.float32) / 255.0
    rgb = a[..., :3]
    lin = np.where(rgb <= 0.04045, rgb / 12.92,
                   ((rgb + 0.055) / 1.055) ** 2.4)
    chans = []
    for c in range(4):
        src = lin[..., c] if c < 3 else a[..., 3]
        chans.append(resample_bilinear(src, TEX_RES, TEX_RES))
    out = np.stack(chans, axis=-1)
    rgbo = np.clip(out[..., :3], 0.0, 1.0)
    srgb = np.where(rgbo <= 0.0031308, rgbo * 12.92,
                    1.055 * rgbo ** (1.0 / 2.4) - 0.055)
    out = np.concatenate([srgb, out[..., 3:]], axis=-1)
    return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)


def _parse_glb_container(data: bytes) -> Tuple[dict, bytes]:
    if len(data) < 12:
        raise ValueError("not a GLB file: too short")
    magic, version, length = struct.unpack_from("<III", data, 0)
    if magic != GLB_MAGIC:
        raise ValueError("not a GLB file: bad magic")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    off = 12
    gltf_json: Optional[dict] = None
    blob = b""
    while off + 8 <= min(length, len(data)):
        clen, ctype = struct.unpack_from("<II", data, off)
        off += 8
        chunk = data[off:off + clen]
        off += clen
        if ctype == CHUNK_JSON and gltf_json is None:
            gltf_json = json.loads(chunk)
        elif ctype == CHUNK_BIN and not blob:
            blob = chunk
    if gltf_json is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf_json, blob


def _read_accessor(gltf: dict, blob: bytes, accessor_index: int
                   ) -> np.ndarray:
    """Decode one accessor to [count, ncomp] (SCALAR -> [count, 1])."""
    acc = gltf["accessors"][accessor_index]
    ncomp = _TYPE_COMPONENTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    if "bufferView" not in acc:  # spec: zero-filled when absent
        return np.zeros((count, ncomp), dtype=dtype)
    view = gltf["bufferViews"][acc["bufferView"]]
    base = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    itemsize = np.dtype(dtype).itemsize
    tight = ncomp * itemsize
    stride = view.get("byteStride", 0) or tight
    if stride == tight:
        out = np.frombuffer(blob, dtype=dtype, count=count * ncomp,
                            offset=base)
        return out.reshape(count, ncomp).copy()
    # Strided: slice per element via as_strided on a bytes view.
    raw = np.frombuffer(blob, dtype=np.uint8,
                        count=stride * (count - 1) + tight, offset=base)
    strided = np.lib.stride_tricks.as_strided(
        raw, shape=(count, tight), strides=(stride, 1))
    return strided.copy().view(dtype).reshape(count, ncomp)


def _local_matrix(node: dict) -> np.ndarray:
    """TRS (or explicit matrix) -> 4x4, glTF column-major convention
    (ref: scene.cpp:18-21 local_matrix)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(np.asarray(node["scale"], np.float64))
    if "rotation" in node:
        x, y, z, w = [float(v) for v in node["rotation"]]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = np.asarray(node["translation"], np.float64)
    return m


def _invert3x3_transpose(m: np.ndarray) -> np.ndarray:
    """Inverse-transpose normal matrix via the adjugate, op for op as
    native/srt_native.cpp invert3x3_transpose, so that bake() and the
    baked ingest agree bit for bit. Works on [..., 3, 3] stacks. A
    matrix with det == 0 (a zero-scale node) gives zeros, as in the
    native core."""
    a = np.asarray(m, np.float64)
    det = (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                           - a[..., 1, 2] * a[..., 2, 1])
           - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                             - a[..., 1, 2] * a[..., 2, 0])
           + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                             - a[..., 1, 1] * a[..., 2, 0]))
    with np.errstate(divide="ignore"):
        inv_det = np.where(det != 0.0, 1.0 / det, 0.0)
    inv = np.stack([
        np.stack([a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1],
                  -(a[..., 0, 1] * a[..., 2, 2]
                    - a[..., 0, 2] * a[..., 2, 1]),
                  a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]],
                 axis=-1),
        np.stack([-(a[..., 1, 0] * a[..., 2, 2]
                    - a[..., 1, 2] * a[..., 2, 0]),
                  a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
                  -(a[..., 0, 0] * a[..., 1, 2]
                    - a[..., 0, 2] * a[..., 1, 0])], axis=-1),
        np.stack([a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0],
                  -(a[..., 0, 0] * a[..., 2, 1]
                    - a[..., 0, 1] * a[..., 2, 0]),
                  a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]],
                 axis=-1),
    ], axis=-2) * inv_det[..., None, None]
    return np.swapaxes(inv, -1, -2)


def _node_world_matrices(gltf: dict, scene_nodes: List[int],
                         global_scale: np.ndarray) -> Dict[int, np.ndarray]:
    """World matrix per reachable node, composed as
    Scene::node_global_matrix (scene.cpp:137-146): every node's own
    chain ends with an innermost scale(global_scale)."""
    nodes = gltf.get("nodes", [])
    scale_m = np.diag(np.concatenate([global_scale, [1.0]]))
    world: Dict[int, np.ndarray] = {}

    def visit(idx: int, parent: np.ndarray):
        chain = parent @ _local_matrix(nodes[idx])
        world[idx] = chain @ scale_m
        for child in nodes[idx].get("children", []):
            visit(child, chain)

    for root in scene_nodes:
        visit(root, np.eye(4))
    return world


def _decode_image(gltf: dict, blob: bytes, image: dict, name: str
                  ) -> np.ndarray:
    """Extract an embedded image's bytes and decode them
    (utils/gltf.py decode_image_bytes)."""
    if "bufferView" in image:
        view = gltf["bufferViews"][image["bufferView"]]
        base = view.get("byteOffset", 0)
        raw = blob[base:base + view["byteLength"]]
    elif "uri" in image and image["uri"].startswith("data:"):
        import base64
        raw = base64.b64decode(image["uri"].split(",", 1)[1])
    else:
        raise ValueError(
            "external image URIs are not supported in .glb ingest")
    return decode_image_bytes(raw, name)


def _default_material() -> dict:
    # Deviation: reference asserts on missing material (scene.cpp:176).
    return {"pbrMetallicRoughness": {
        "baseColorFactor": [0.8, 0.8, 0.8, 1.0],
        "metallicFactor": 0.0,
        "roughnessFactor": 0.5,
    }}


def _classify_materials(gltf: dict) -> HostMaterialTable:
    """Reference classification rules, scene.cpp:188-254."""
    gltf_mats = list(gltf.get("materials", []))
    gltf_mats.append(_default_material())  # slot M-1 = default material
    m = len(gltf_mats)
    mtype = np.zeros(m, np.uint8)
    albedo = np.ones((m, 3), np.float32)
    tex_id = np.full(m, -1, np.int32)
    roughness = np.zeros(m, np.float32)
    ior = np.full(m, 1.5, np.float32)
    emissive = np.zeros((m, 3), np.float32)

    textures = gltf.get("textures", [])
    for i, mat in enumerate(gltf_mats):
        pbr = mat.get("pbrMetallicRoughness", {})
        base_color = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])[:3]
        ext = mat.get("extensions", {})

        emissive_factor = np.asarray(
            mat.get("emissiveFactor", [0.0, 0.0, 0.0]), np.float32)
        strength = 0.0
        if "KHR_materials_emissive_strength" in ext:
            strength = float(ext["KHR_materials_emissive_strength"].get(
                "emissiveStrength", 1.0))
        emissive[i] = emissive_factor * strength

        base_tex = -1
        bct = pbr.get("baseColorTexture")
        if bct is not None and bct.get("index", -1) > -1:
            base_tex = int(textures[bct["index"]].get("source", -1))

        if "KHR_materials_ior" in ext and "KHR_materials_transmission" in ext:
            mtype[i] = MAT_DIELECTRIC
            ior[i] = float(ext["KHR_materials_ior"].get("ior", 1.5))
            emissive[i] = 0.0  # dielectric never emits (material.hpp:158-160)
        elif float(pbr.get("metallicFactor", 1.0)) > 0.01:
            mtype[i] = MAT_METALLIC
            albedo[i] = base_color
            tex_id[i] = base_tex
            roughness[i] = float(pbr.get("roughnessFactor", 1.0))
        else:
            mtype[i] = MAT_DIFFUSE
            albedo[i] = base_color
            tex_id[i] = base_tex

    return HostMaterialTable(mtype=mtype, albedo=albedo, tex_id=tex_id,
                             roughness=roughness, ior=ior,
                             emissive=emissive)


def _geometric_normals(v: np.ndarray) -> np.ndarray:
    """Per-face normals [N,3] from positions [N,3,3] (fallback)."""
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-20)


def _extract_camera(gltf, world, camera_node, tri_v):
    """Camera pose per scene.cpp:109-128; deterministic bbox default
    when no camera node exists (deviation: the reference would index
    nodes[-1])."""
    if camera_node is not None and camera_node in world:
        m = world[camera_node]
        pos = m[:3, 3].copy()
        # rotation applied to glTF forward (0,0,-1); use the rotation
        # part of the world matrix with scale removed.
        r = m[:3, :3]
        r = r / np.maximum(np.linalg.norm(r, axis=0, keepdims=True), 1e-20)
        direction = r @ np.array([0.0, 0.0, -1.0])
        direction = direction / max(np.linalg.norm(direction), 1e-20)
        cam_ref = gltf["nodes"][camera_node]["camera"]
        persp = gltf.get("cameras", [{}])[cam_ref].get("perspective", {})
        yfov = float(persp.get("yfov", np.deg2rad(45.0)))
        focal = 1.0 / np.tan(yfov / 2.0)  # scene.cpp:127
        return pos, direction, focal

    # Default: frame the scene bbox from +Z.
    if tri_v.size:
        lo = tri_v.reshape(-1, 3).min(0)
        hi = tri_v.reshape(-1, 3).max(0)
        center = 0.5 * (lo + hi)
        extent = float(np.max(hi - lo))
    else:
        center = np.zeros(3)
        extent = 1.0
    pos = center + np.array([0.0, 0.0, 2.0 * max(extent, 1e-6)])
    direction = np.array([0.0, 0.0, -1.0])
    focal = 1.0 / np.tan(np.deg2rad(45.0) / 2.0)
    return pos, direction, focal


def _read_scene(gltf: dict, blob: bytes, global_scale):
    """What both Python ingests read before the primitives: (world
    matrix per reachable node, sky color [3] f32, material table,
    textures [T, TEX_RES, TEX_RES, 4] uint8) of the GLB's scene."""
    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [{}])
    scene = scenes[scene_idx if 0 <= scene_idx < len(scenes) else 0]
    # sky: scene.extras (scene.cpp:80-94)
    extras = scene.get("extras", {})
    sky = np.asarray(extras.get("sky_color", DEFAULT_SKY),
                     np.float32).reshape(-1)[:3]
    if sky.shape[0] != 3:  # malformed extras: never emit a [2] sky
        sky = np.asarray(DEFAULT_SKY, np.float32)
    if "sky_strength" in extras:
        sky = sky * np.float32(extras["sky_strength"])
    world = _node_world_matrices(gltf, scene.get("nodes", []),
                                 np.asarray(global_scale, np.float64))
    materials = _classify_materials(gltf)
    images = gltf.get("images", [])[:MAX_IMAGES]
    if images:
        textures = np.stack([_decode_image(gltf, blob, im, f"image {i}")
                             for i, im in enumerate(images)])
    else:
        textures = np.zeros((1, TEX_RES, TEX_RES, 4), np.uint8)
    return world, sky.astype(np.float32), materials, textures


def _read_primitive(gltf: dict, blob: bytes, prim: dict):
    """One mesh primitive's accessors: (positions [P, 3] f64, triangle
    vertex indices [3T] i64, normals [P, 3] f64 or None, uvs [P, 2] f32
    or None, material index or -1)."""
    attrs = prim.get("attributes", {})
    if "POSITION" not in attrs:
        raise ValueError("primitive without POSITION attribute")
    pos = _read_accessor(gltf, blob, attrs["POSITION"]).astype(np.float64)
    if "indices" in prim:
        idx = _read_accessor(gltf, blob, prim["indices"]).reshape(-1)
        idx = idx.astype(np.int64)
    else:
        idx = np.arange(pos.shape[0], dtype=np.int64)
    if idx.size % 3 != 0:
        raise ValueError("index count not divisible by 3")
    nrm = (_read_accessor(gltf, blob, attrs["NORMAL"]).astype(np.float64)
           if "NORMAL" in attrs else None)
    uv = (_read_accessor(gltf, blob, attrs["TEXCOORD_0"]).astype(np.float32)
          if "TEXCOORD_0" in attrs else None)
    return pos, idx, nrm, uv, prim.get("material", -1)


def _read_bytes(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()


def load_glb(path_or_bytes, global_scale=(1.0, 1.0, 1.0),
             use_native: bool = True) -> HostScene:
    """Parse a .glb file (path or bytes) into a flat world-space
    HostScene; global_scale (SX, SY, SZ) is the innermost scale of every
    node's world matrix, as the reference Scene applies it
    (scene.cpp:137-146). use_native=True (the default) parses with the
    native ingest core and raises if it fails; use_native=False parses
    in Python (numpy). There is no fallback from one to the other."""
    data = _read_bytes(path_or_bytes)
    if use_native:
        from sycl_ray_tracer_torch.utils import native_loader

        return native_loader.load_glb_native(data, global_scale)
    return _load_glb_python(data, global_scale)


def ingest_mismatch(nat, py) -> list:
    """The fields in which two HostScenes of one file (the native and the
    Python ingest's) differ beyond the JAX package's tolerances for its
    two ingests: geometry to 1e-5 (uv 1e-6), the camera to 1e-5 / 1e-6,
    material ids, triangle materials and textures exactly."""
    close = {
        "count": nat.num_triangles == py.num_triangles,
        "tri_v": np.allclose(nat.tri_v, py.tri_v, atol=1e-5),
        "tri_n": np.allclose(nat.tri_n, py.tri_n, atol=1e-5),
        "tri_uv": np.allclose(nat.tri_uv, py.tri_uv, atol=1e-6),
        "tri_mat": np.array_equal(nat.tri_mat, py.tri_mat),
        "textures": np.array_equal(nat.textures, py.textures),
        "materials": all(
            np.array_equal(getattr(nat.materials, f),
                           getattr(py.materials, f))
            for f in ("mtype", "tex_id")) and all(
            np.allclose(getattr(nat.materials, f), getattr(py.materials, f))
            for f in ("albedo", "roughness", "ior", "emissive")),
        "sky": np.allclose(nat.sky_color, py.sky_color),
        "camera": (np.allclose(nat.camera_position, py.camera_position,
                               atol=1e-5)
                   and np.allclose(nat.camera_direction,
                                   py.camera_direction, atol=1e-6)
                   and np.isclose(nat.camera_focal_length,
                                  py.camera_focal_length)),
    }
    return [k for k, v in close.items() if not v]


def _load_glb_python(data: bytes, global_scale) -> HostScene:
    """The Python ingest: every (node, primitive) instance baked to
    world space, normals by the inverse transpose of the node's 3x3
    matrix (scene.cpp:502), op for op as the JAX package's
    utils/gltf.py:load_glb(use_native=False)."""
    gltf, blob = _parse_glb_container(data)
    world, sky, materials, textures = _read_scene(gltf, blob, global_scale)
    default_mat_index = len(materials.mtype) - 1
    nodes = gltf.get("nodes", [])
    meshes = gltf.get("meshes", [])

    tri_v_parts, tri_n_parts, tri_uv_parts, tri_mat_parts = [], [], [], []
    camera_node: Optional[int] = None
    for node_idx, mat4 in world.items():
        node = nodes[node_idx]
        if "camera" in node and camera_node is None:
            camera_node = node_idx
        if "mesh" not in node:
            continue
        m3 = mat4[:3, :3]
        normal_m = _invert3x3_transpose(m3)
        for prim in meshes[node["mesh"]].get("primitives", []):
            pos, idx, nrm, uv, mat_index = _read_primitive(gltf, blob, prim)
            world_pos = pos @ m3.T + mat4[:3, 3]
            v = world_pos[idx].reshape(-1, 3, 3).astype(np.float32)
            if nrm is not None:
                n = (nrm @ normal_m.T)[idx].reshape(-1, 3, 3).astype(
                    np.float32)
            else:
                n = np.repeat(_geometric_normals(v)[:, None, :], 3, axis=1)
            uv = (uv[idx].reshape(-1, 3, 2) if uv is not None
                  else np.zeros((v.shape[0], 3, 2), np.float32))
            tri_v_parts.append(v)
            tri_n_parts.append(n)
            tri_uv_parts.append(uv)
            tri_mat_parts.append(np.full(
                v.shape[0], mat_index if mat_index >= 0 else
                default_mat_index, np.int32))

    if tri_v_parts:
        tri_v = np.concatenate(tri_v_parts)
        tri_n = np.concatenate(tri_n_parts)
        tri_uv = np.concatenate(tri_uv_parts)
        tri_mat = np.concatenate(tri_mat_parts)
    else:
        tri_v = np.zeros((0, 3, 3), np.float32)
        tri_n = np.zeros((0, 3, 3), np.float32)
        tri_uv = np.zeros((0, 3, 2), np.float32)
        tri_mat = np.zeros((0,), np.int32)
    cam_pos, cam_dir, focal = _extract_camera(gltf, world, camera_node,
                                              tri_v)
    return HostScene(
        tri_v=tri_v, tri_n=tri_n, tri_uv=tri_uv, tri_mat=tri_mat,
        materials=materials, textures=textures, sky_color=sky,
        camera_position=cam_pos.astype(np.float32),
        camera_direction=cam_dir.astype(np.float32),
        camera_focal_length=float(focal))
