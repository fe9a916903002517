"""Binary glTF (.glb) ingest -> flat host-side scene arrays.

Replaces the reference's tiny_gltf + Embree instancing pipeline
(scene.cpp:54-510). The GLB container, accessors, node transforms and
material classification are parsed by the shared native core
(native/srt_native.cpp, through utils/native_loader.py), which the SAH
build needs anyway; this module holds the host-side scene types and
the image decode. Differences from the reference by design:

- Instancing is *baked*: every (node, primitive) instance's vertices are
  transformed to world space at load (the reference instead builds
  Embree BLAS-per-primitive + TLAS-of-instances, scene.cpp:404-439,
  487-507, and transforms in-kernel).
- Embedded PNG textures are decoded by utils/png.py (stdlib + numpy)
  and resized to TEX_RES x TEX_RES by resample_bilinear (numpy, equal
  to Pillow's resize); an imaging library is needed only to decode
  another format.

Material classification (scene.cpp:188-254, done by the native core):
  dielectric  iff KHR_materials_ior AND KHR_materials_transmission
  else metallic iff pbr.metallicFactor > 0.01
  else diffuse
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np

GLB_MAGIC = 0x46546C67
CHUNK_JSON = 0x4E4F534A
CHUNK_BIN = 0x004E4942

# Fixed texture-atlas resolution, matching the reference's ImageManager
# (image_manager.hpp:12-14: 512x512 RGBA).
TEX_RES = 512

MAT_DIFFUSE = 0
MAT_METALLIC = 1
MAT_DIELECTRIC = 2


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


def load_glb(path_or_bytes, global_scale=(1.0, 1.0, 1.0)) -> HostScene:
    """Parse a .glb file (path or bytes) into a flat world-space
    HostScene with the native ingest core; global_scale (SX, SY, SZ) is
    the innermost scale of every node's world matrix, as the reference
    Scene applies it (scene.cpp:137-146)."""
    from sycl_ray_tracer_torch.utils import native_loader

    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    return native_loader.load_glb_native(data, global_scale)
