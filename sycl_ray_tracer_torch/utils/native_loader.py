"""ctypes bindings for the native C++ library (native/srt_native.cpp,
native/srt_bvh.cpp): GLB ingest and the binned-SAH BVH8 build.

The library is built from the repository's shared top-level `native/`
sources with `make -C native BUILD=<repo>/build/native` on first use,
under a file lock so that concurrent processes build it once. The
port's copy of the library is its own file, so the port never loads
a library that another package's build is rewriting. The port's main
path needs it for the SAH build, so a library that cannot be built or
loaded raises instead of falling back.

The native core handles the heavy ingest (GLB/JSON/accessors/transform
baking/material classification, the tiny_gltf-equivalent layer); image
decoding stays in Python (utils/gltf.py decode_image_bytes). The
global scale (the reference Scene's global_scale) is applied by the
native core, innermost in every node's world matrix.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libsrt_native.so")

_lib = None


def _stale() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    # the Makefile counts as a source: a flag change must rebuild too
    return any((f.endswith(".cpp") or f == "Makefile")
               and os.path.getmtime(os.path.join(_NATIVE_DIR, f)) > lib_mtime
               for f in os.listdir(_NATIVE_DIR))


def load_library() -> ctypes.CDLL:
    """Build (if missing or stale) and load the native library."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if _stale():
                proc = subprocess.run(
                    ["make", "-C", _NATIVE_DIR, f"BUILD={_BUILD_DIR}"],
                    capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"building the native library failed (make -C "
                        f"native BUILD={_BUILD_DIR}):\n"
                        f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(_LIB_PATH)

    lib.srt_load_glb.restype = ctypes.c_void_p
    lib.srt_load_glb.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_float)]
    lib.srt_error.restype = ctypes.c_char_p
    lib.srt_error.argtypes = [ctypes.c_void_p]
    for name in ("srt_num_triangles", "srt_num_materials",
                 "srt_num_images"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.srt_image_size.restype = ctypes.c_int64
    lib.srt_image_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.srt_copy_geometry.argtypes = [ctypes.c_void_p] + [
        ctypes.c_void_p] * 4
    lib.srt_copy_materials.argtypes = [ctypes.c_void_p] + [
        ctypes.c_void_p] * 6
    lib.srt_scene_info.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
    lib.srt_copy_image.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                   ctypes.c_void_p]
    lib.srt_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def load_glb_native(data: bytes, global_scale=(1.0, 1.0, 1.0)):
    """Parse GLB with the native core into a HostScene, at global_scale
    (SX, SY, SZ)."""
    from sycl_ray_tracer_torch.utils.gltf import (TEX_RES, HostMaterialTable,
                                                HostScene)

    lib = load_library()
    scale = (ctypes.c_float * 3)(*[float(x) for x in global_scale])
    handle = lib.srt_load_glb(data, len(data), scale)
    if not handle:
        raise RuntimeError("native loader returned null")
    handle = ctypes.c_void_p(handle)
    try:
        err = lib.srt_error(handle)
        if err:
            raise ValueError(f"native GLB parse failed: {err.decode()}")

        n = lib.srt_num_triangles(handle)
        m = lib.srt_num_materials(handle)

        tri_v = np.empty((n, 3, 3), np.float32)
        tri_n = np.empty((n, 3, 3), np.float32)
        tri_uv = np.empty((n, 3, 2), np.float32)
        tri_mat = np.empty((n,), np.int32)
        lib.srt_copy_geometry(
            handle,
            tri_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tri_n.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tri_uv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tri_mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))

        mtype = np.empty((m,), np.int32)
        albedo = np.empty((m, 3), np.float32)
        tex = np.empty((m,), np.int32)
        rough = np.empty((m,), np.float32)
        ior = np.empty((m,), np.float32)
        emissive = np.empty((m, 3), np.float32)
        lib.srt_copy_materials(
            handle,
            mtype.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            albedo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tex.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rough.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ior.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            emissive.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

        sky = (ctypes.c_float * 3)()
        pos = (ctypes.c_float * 3)()
        dirn = (ctypes.c_float * 3)()
        focal = ctypes.c_float()
        has_cam = ctypes.c_int32()
        lib.srt_scene_info(handle, sky, pos, dirn,
                           ctypes.byref(focal), ctypes.byref(has_cam))

        # the native core hands back raw embedded image bytes
        n_img = lib.srt_num_images(handle)
        if n_img:
            from sycl_ray_tracer_torch.utils.gltf import decode_image_bytes

            imgs = []
            for i in range(n_img):
                size = lib.srt_image_size(handle, i)
                buf = np.empty((size,), np.uint8)
                lib.srt_copy_image(
                    handle, i,
                    buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
                imgs.append(decode_image_bytes(buf.tobytes(), f"image {i}"))
            textures = np.stack(imgs)
        else:
            textures = np.zeros((1, TEX_RES, TEX_RES, 4), np.uint8)

        mats = HostMaterialTable(
            mtype=mtype.astype(np.uint8), albedo=albedo, tex_id=tex,
            roughness=rough, ior=ior, emissive=emissive)
        return HostScene(
            tri_v=tri_v, tri_n=tri_n, tri_uv=tri_uv, tri_mat=tri_mat,
            materials=mats, textures=textures,
            sky_color=np.asarray(sky, np.float32),
            camera_position=np.asarray(pos, np.float32),
            camera_direction=np.asarray(dirn, np.float32),
            camera_focal_length=float(focal.value),
        )
    finally:
        lib.srt_free(handle)
