"""Build, load and launch the port's hand-written kernels.

Every CUDA source in csrc/ (CUDA_SOURCES) is compiled by nvcc for
sm_90a, one process per source, all started together, and linked into
one shared library with a plain C interface in build/kernels/, at the
first launch; ctypes loads it. The host build of the same per-ray walks,
per-lane bounce stages and queue compaction (csrc/walk_host.cpp,
csrc/vertex_host.cpp, csrc/compact_host.cpp, g++) is the CPU tests' view
of the kernels' code.
Both libraries are keyed by a hash of every file in csrc/ plus the
compiler and its flags, so an edit rebuilds them.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

import torch

from sycl_ray_tracer_torch.ops.intersect import Hit
from sycl_ray_tracer_torch.ops.vec import V3

# Per-thread stack depth; must equal SRT_STACK in csrc/bvh8_walk.cuh
# (checked when a library loads).
STACK = 128

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
CUDA_SOURCES = ("traverse8.cu", "traverse5.cu", "traverse1.cu", "vertex.cu",
                "compact.cu")
# kernels whose C entry takes scheduling scratch after n_rays: the list
# of live lanes (int32 [R], with an active mask) and two zeroed 64-bit
# counters (csrc/schedule.cuh)
SCHEDULED = ("traverse8", "traverse5", "traverse1")
# traverse8's second masked entry, srt_traverse8_ordered, takes the
# scene's box (lo, hi: f32 [3] each) after the scratch and walks the live
# lanes in order of the top ORDER_BITS bits of their dir6_morton key
# (csrc/order.cuh), their rays gathered first into records of
# RECORD_FLOATS f32 ([R, 8] in place of the list); its counters are 2 +
# ORDER_BINS / 2 words, the bins' counts after the two
ORDER_BITS = 20
RECORD_FLOATS = 8
ORDER_BINS = 24 << (ORDER_BITS - 7)
HOST_SOURCES = ("walk_host.cpp", "vertex_host.cpp", "compact_host.cpp",
                "order_host.cpp")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# No --use_fast_math (dead slots need IEEE inf/NaN). FMA contraction is
# off so that the kernels round exactly as their plain torch versions
# do and agree bit for bit, equal-t ties included but for the rare case
# that csrc/bvh8_walk.cuh names.
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                     "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
# argument types of the C entry points, ahead of the 12 ray/output
# pointers (ox oy oz dx dy dz active t_init t tri u v), n_rays, and the
# stream (card) or the walk counts (host)
_TABLES = {"traverse8": [_P, _P, _P, _I32],
           "traverse5": [_P, _P, _P, _P, _P, _I32],
           "traverse1": [_P, _P, _I32, _I32, _I32]}
# argument types of the bounce stages', the compaction's and the walk
# order's C entry points (csrc/vertex.cu, csrc/compact.cu,
# csrc/traverse8.cu), ahead of the stream (card); the stages' and the
# compaction's structs are built by ops/vertex.py and ops/compact.py
_STAGES = {"shade": [_P, _P, _I32, _P, _P, _P, _I64],
           "scatter_queue": [_P, _P],
           "scatter_paths": [_P, _P],
           "compact_keys": [_P, _P],
           "compact_sort": [_P],
           "compact_gather": [_P, _P, _I64, _P, _P],
           "traverse8_order": [_P] * 13 + [_I64, _P, _P]}

_lib = None
_host_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _run_all(cmds) -> str:
    """Run the commands in parallel; return their joined output, or
    raise with it once all have ended if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], False
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate(timeout=600)
        logs.append(" ".join(cmd) + "\n" + out)
        failed |= p.returncode != 0
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"kernel build failed:\n{log}")
    return log


def _build(stem: str, key: list, make) -> str:
    """Build build/kernels/<stem>-<hash>.so with make(tmp_path) -> log
    unless that file exists. The library is written under a temporary
    name and renamed into place, under a file lock, so concurrent
    processes neither collide nor load a half-written library. The
    build's output goes to <so>.log."""
    h = hashlib.sha256(" ".join(key).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        log = make(tmp)
        with open(out + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)
    return out


def build_library() -> str:
    """Build the CUDA kernel library (nvcc, sm_90a); returns its path."""
    nvcc = _nvcc()

    def make(tmp):
        objs = [f"{tmp}.{src}.o" for src in CUDA_SOURCES]
        log = _run_all([[nvcc] + NVCC_FLAGS + ["-c", "-I", CSRC, "-o", obj,
                                                os.path.join(CSRC, src)]
                        for src, obj in zip(CUDA_SOURCES, objs)])
        log += _run_all([[nvcc] + ARCH + ["-shared", "-o", tmp] + objs])
        for obj in objs:
            os.remove(obj)
        return log

    return _build("kernels", [nvcc] + NVCC_FLAGS, make)


def build_host_library() -> str:
    """Build the host (g++) library of the same per-ray walks and
    bounce stages."""
    def make(tmp):
        return _run_all([["g++"] + GXX_FLAGS + [
            "-I", CSRC, "-o", tmp] + [os.path.join(CSRC, src)
                                      for src in HOST_SOURCES]])

    return _build("walk_host", ["g++"] + GXX_FLAGS, make)


def _bind(lib: ctypes.CDLL, suffix: str, tail: list,
          stage_tail: list) -> ctypes.CDLL:
    for name, tables in _TABLES.items():
        fn = getattr(lib, f"srt_{name}{suffix}")
        fn.argtypes = tables + [_P] * 12 + tail
    for name, args in _STAGES.items():
        getattr(lib, f"srt_{name}{suffix}").argtypes = args + stage_tail
    lib.srt_stack.restype = ctypes.c_int
    if lib.srt_stack() != STACK:
        raise RuntimeError("csrc/bvh8_walk.cuh SRT_STACK differs from "
                           "ops/kernels.py STACK")
    lib.srt_order_bins.restype = ctypes.c_int
    if lib.srt_order_bins() != ORDER_BINS:
        raise RuntimeError("csrc/order.cuh kOrderBins differs from "
                           "ops/kernels.py ORDER_BINS")
    return lib


def load_library() -> ctypes.CDLL:
    """The CUDA kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = _bind(ctypes.CDLL(build_library()), "", [_I64, _P], [_P])
        for name in (*_TABLES, *_STAGES):
            fn = getattr(lib, f"srt_{name}")
            fn.restype = ctypes.c_int
            if name in SCHEDULED:
                fn.argtypes = fn.argtypes[:-1] + [_P, _P, _P]
        lib.srt_traverse8_ordered.argtypes = (
            lib.srt_traverse8.argtypes[:-1] + [_P, _P, _P])
        lib.srt_traverse8_ordered.restype = ctypes.c_int
        lib.srt_compact_sort_scratch.argtypes = [_I64]
        lib.srt_compact_sort_scratch.restype = _I64
        _lib = lib
    return _lib


def load_host_library() -> ctypes.CDLL:
    """The g++ build of the kernels' per-ray walks, for the CPU tests."""
    global _host_lib
    if _host_lib is None:
        lib = _bind(ctypes.CDLL(build_host_library()), "_host", [_I64, _P],
                    [])
        for name in (*_TABLES, *_STAGES):
            getattr(lib, f"srt_{name}_host").restype = None
        _host_lib = lib
    return _host_lib


def entry_device(t: torch.Tensor) -> torch.device:
    """t's device, where the entries of _STAGES run: cuda (the kernel) or
    cpu (its host build)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the bounce stages, the compaction and the walk "
                         f"order run on cuda or cpu, not {t.device}")
    return t.device


def call(name: str, dev: torch.device, *args) -> None:
    """Run entry srt_<name> of _STAGES (the stages', the compaction's or
    the walk order's): the kernel on the current stream of a CUDA device,
    or its host build on the CPU."""
    if dev.type == "cpu":
        getattr(load_host_library(), f"srt_{name}_host")(*args)
        return
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(load_library(), f"srt_{name}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing cuda on a machine without CUDA:
    the port's entry points run on the card unless asked for the CPU,
    and never fall back to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless t is a contiguous `dtype` tensor of `shape` on
    `device`."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(name: str, t: torch.Tensor) -> None:
    """Raise unless t's data starts on a 16-byte boundary: the kernels
    read tables with 16-byte loads."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def check_rays(o: V3, d: V3, active, t_init, device) -> None:
    """Check the ray columns of a launch."""
    r = o.x.shape[0]
    for name, c in zip(("ox", "oy", "oz", "dx", "dy", "dz"), (*o, *d)):
        check(name, c, torch.float32, (r,), device)
    if active is not None:
        check("active", active, torch.bool, (r,), device)
    if t_init is not None:
        check("t_init", t_init, torch.float32, (r,), device)


def _ptr(x):
    return None if x is None else x.data_ptr()


def launch(name: str, tables: list, o: V3, d: V3, active, t_init,
           device, order_box=None) -> Hit:
    """Launch the kernel `name` on the current stream of `device` with
    checked inputs (tables are tensors, or ints passed as int32);
    raises if CUDA reports an error for the launch. order_box (lo, hi)
    launches traverse8's ordered entry (with a mask)."""
    r = o.x.shape[0]
    if r >= 2**31:
        raise ValueError(f"{name}: at most 2**31 - 1 rays per launch")
    t = torch.empty((r,), dtype=torch.float32, device=device)
    tri = torch.empty((r,), dtype=torch.int32, device=device)
    u = torch.empty((r,), dtype=torch.float32, device=device)
    v = torch.empty((r,), dtype=torch.float32, device=device)
    fn = getattr(load_library(),
                 f"srt_{name}" + ("" if order_box is None else "_ordered"))
    args = [x if isinstance(x, int) else _ptr(x) for x in tables]
    with torch.cuda.device(device):
        # the scratch may be freed once the launch is queued: the caching
        # allocator gives its memory only to work queued after it on
        # this stream
        scratch = []
        if name in SCHEDULED:
            if active is None:
                lanes = None
            elif order_box is None:
                lanes = torch.empty((r,), dtype=torch.int32, device=device)
            else:  # the ordered entry's records of the live rays
                lanes = torch.empty((r, RECORD_FLOATS), dtype=torch.float32,
                                    device=device)
            counters = torch.zeros(
                (2 + (0 if order_box is None else ORDER_BINS // 2),),
                dtype=torch.int64, device=device)
            scratch = [_ptr(lanes), counters.data_ptr()]
        if order_box is not None:
            scratch += [b.data_ptr() for b in order_box]
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, *(c.data_ptr() for c in (*o, *d)), _ptr(active),
                 _ptr(t_init), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
                 v.data_ptr(), r, *scratch, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return Hit(t=t, tri=tri, u=u, v=v)


def run_host(name: str, tables: list, o: V3, d: V3, active=None,
             t_init=None, counts: torch.Tensor | None = None) -> Hit:
    """The host build of kernel `name`'s walk on CPU tensors. `counts`
    (int64 [2]) gains the child boxes slab-tested and the leaves tested
    by these rays' walks."""
    r = o.x.shape[0]
    out = (torch.empty(r), torch.empty(r, dtype=torch.int32),
           torch.empty(r), torch.empty(r))
    args = [x if isinstance(x, int) else _ptr(x) for x in tables]
    if counts is not None:
        check("counts", counts, torch.int64, (2,), torch.device("cpu"))
    getattr(load_host_library(), f"srt_{name}_host")(
        *args, *(c.data_ptr() for c in (*o, *d)), _ptr(active),
        _ptr(t_init), *(x.data_ptr() for x in out), r, _ptr(counts))
    return Hit(*out)
