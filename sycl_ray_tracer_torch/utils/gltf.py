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
- Embedded PNG textures are decoded by utils/png.py (stdlib + numpy);
  an imaging library is needed only to resize a texture that is not
  TEX_RES x TEX_RES, or to decode another format.

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


def decode_image_bytes(raw: bytes, name: str = "image") -> np.ndarray:
    """Decode encoded image bytes to TEX_RES x TEX_RES RGBA uint8.

    A TEX_RES x TEX_RES 8-bit RGB/RGBA PNG (every procedural scene's
    texture) decodes through utils/png.py. Any other size goes through
    an sRGB-AWARE resize, mirroring the reference's
    stbir_resize_uint8_srgb (image_manager.hpp:51-61): color channels
    are converted to linear, filtered there, and re-encoded; alpha is
    filtered linearly as-is. That resize, and formats other than
    PNG, need Pillow; without it they raise NotImplementedError rather
    than approximate."""
    px = None
    if raw[:8] == b"\x89PNG\r\n\x1a\n":
        from sycl_ray_tracer_torch.utils.png import decode_png

        try:
            px = decode_png(raw)
        except ValueError:
            px = None  # a PNG variant the stdlib decoder does not cover
    if px is not None and px.shape[:2] == (TEX_RES, TEX_RES):
        if px.shape[2] == 3:
            px = np.concatenate(
                [px, np.full(px.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        return px
    try:
        from PIL import Image
    except ImportError:
        what = (f"{px.shape[1]}x{px.shape[0]} texture (resize to "
                f"{TEX_RES}x{TEX_RES})" if px is not None
                else "non-PNG or unsupported PNG texture")
        raise NotImplementedError(
            f"{name}: decoding this {what} needs Pillow, which is not "
            f"installed") from None

    img = Image.open(io.BytesIO(raw)).convert("RGBA")
    if img.size == (TEX_RES, TEX_RES):
        return np.asarray(img, dtype=np.uint8)
    a = np.asarray(img, np.float32) / 255.0
    rgb = a[..., :3]
    lin = np.where(rgb <= 0.04045, rgb / 12.92,
                   ((rgb + 0.055) / 1.055) ** 2.4)
    chans = []
    for c in range(4):
        src = lin[..., c] if c < 3 else a[..., 3]
        ch = Image.fromarray(np.ascontiguousarray(src), mode="F")
        ch = ch.resize((TEX_RES, TEX_RES), Image.BILINEAR)
        chans.append(np.asarray(ch, np.float32))
    out = np.stack(chans, axis=-1)
    rgbo = np.clip(out[..., :3], 0.0, 1.0)
    srgb = np.where(rgbo <= 0.0031308, rgbo * 12.92,
                    1.055 * rgbo ** (1.0 / 2.4) - 0.055)
    out = np.concatenate([srgb, out[..., 3:]], axis=-1)
    return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)


def load_glb(path_or_bytes) -> HostScene:
    """Parse a .glb file (path or bytes) into a flat world-space
    HostScene with the native ingest core."""
    from sycl_ray_tracer_torch.utils import native_loader

    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    return native_loader.load_glb_native(data)
