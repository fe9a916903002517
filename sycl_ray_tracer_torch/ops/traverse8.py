"""Closest-hit traversal of the SAH BVH8 with Woop leaf tests.

`traverse8` is the port of the JAX package's Pallas kernel
traverse_packets8 (sycl_ray_tracer_tpu/ops/traverse_pallas8.py:371).
For each active ray (origin o, unnormalized direction d, incumbent
t_init) it returns the closest triangle hit with TNEAR < t < t_init as
Hit(t f32, tri i32 leaf-slot id leaf_row*8 + j, u f32, v f32); the
caller maps slot ids to the canonical Morton order. Active rays without
such a hit get tri = -1 and t = t_init; inactive rays get t = 0 and
tri = -1; u = v = 0 whenever tri = -1.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/traverse8.cu, one thread per ray, built with nvcc for sm_90a at
first use and loaded through ctypes); on a CPU tensor it runs
`traverse8_plain`, the same function in plain torch. There is no
fallback between the two.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

import torch

from sycl_ray_tracer_torch.ops.intersect import BIG, TNEAR, Hit
from sycl_ray_tracer_torch.ops.vec import V3

# Per-thread stack depth; must equal SRT_STACK in csrc/traverse8.cuh
# (checked when the library loads).
STACK = 64

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
# No --use_fast_math (dead slots need IEEE inf/NaN). FMA contraction is
# off so that the kernel rounds exactly as traverse8_plain does and the
# two agree bit for bit outside equal-t ties.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lib = None


def _build(compiler: str, flags, source: str, stem: str) -> str:
    """Compile csrc/<source> (plus the shared header) into
    build/kernels/<stem>-<hash>.so unless that file exists. The output
    is written under a temporary name and renamed into place, under a
    file lock, so concurrent processes neither collide nor load a
    half-written library. The compiler's output goes to <so>.log."""
    h = hashlib.sha256(" ".join([compiler] + list(flags)).encode())
    for name in (source, "traverse8.cuh"):
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
        cmd = ([compiler] + list(flags) + ["-I", CSRC, "-o", tmp,
                                           os.path.join(CSRC, source)])
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        with open(out + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build_library() -> str:
    """Build the CUDA kernel library (nvcc, sm_90a); returns its path."""
    return _build(_nvcc(), NVCC_FLAGS, "traverse8.cu", "traverse8")


def build_host_library() -> str:
    """Build the host (g++) library of the same per-ray walk."""
    return _build("g++", GXX_FLAGS, "traverse8_host.cpp", "traverse8_host")


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.srt_traverse8.restype = ctypes.c_int
        lib.srt_traverse8.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int32]
            + [ctypes.c_void_p] * 12 + [ctypes.c_int64, ctypes.c_void_p])
        lib.srt_traverse8_stack.restype = ctypes.c_int
        if lib.srt_traverse8_stack() != STACK:
            raise RuntimeError("csrc/traverse8.cuh SRT_STACK differs from "
                               "ops/traverse8.py STACK")
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def traverse8(nodes: torch.Tensor, child_ids: torch.Tensor,
              woop: torch.Tensor, ni: int, o: V3, d: V3,
              active: torch.Tensor | None = None,
              t_init: torch.Tensor | None = None) -> Hit:
    """nodes [NI, 48] f32, child_ids [NI, 8] i32, woop [S, 12] f32,
    o/d V3 of [R] f32, active [R] bool or None (all active), t_init [R]
    f32 or None (BIG). See the module docstring for the semantics."""
    dev = nodes.device
    if dev.type == "cpu":
        return traverse8_plain(nodes, child_ids, woop, ni, o, d,
                               active=active, t_init=t_init)
    if dev.type != "cuda":
        raise ValueError(f"traverse8 runs on cuda or cpu, not {dev}")
    r = o.x.shape[0]
    _check("nodes", nodes, torch.float32, (ni, 48), dev)
    _check("child_ids", child_ids, torch.int32, (ni, 8), dev)
    _check("woop", woop, torch.float32, (woop.shape[0], 12), dev)
    for name, c in zip(("ox", "oy", "oz", "dx", "dy", "dz"), (*o, *d)):
        _check(name, c, torch.float32, (r,), dev)
    if active is not None:
        _check("active", active, torch.bool, (r,), dev)
    if t_init is not None:
        _check("t_init", t_init, torch.float32, (r,), dev)
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    tri = torch.empty((r,), dtype=torch.int32, device=dev)
    u = torch.empty((r,), dtype=torch.float32, device=dev)
    v = torch.empty((r,), dtype=torch.float32, device=dev)
    lib = _load()
    ptr = (lambda x: None if x is None else x.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.srt_traverse8(
            nodes.data_ptr(), child_ids.data_ptr(), woop.data_ptr(), ni,
            *(c.data_ptr() for c in (*o, *d)), ptr(active), ptr(t_init),
            t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(), r,
            stream)
    if err != 0:
        raise RuntimeError(f"traverse8 kernel launch failed: CUDA error "
                           f"{err}")
    traverse8.launches += 1
    return Hit(t=t, tri=tri, u=u, v=v)


traverse8.launches = 0


def traverse8_plain(nodes: torch.Tensor, child_ids: torch.Tensor,
                    woop: torch.Tensor, ni: int, o: V3, d: V3,
                    active: torch.Tensor | None = None,
                    t_init: torch.Tensor | None = None) -> Hit:
    """The same function in plain torch: a level-synchronous walk over
    (ray, node) pairs. Each level slab-tests all 8 children of every
    pair, Woop-tests the accepted leaves, folds the per-ray minimum
    into t_best with scatter_reduce("amin"), and descends into the
    accepted internal children."""
    dev = o.x.device
    r = o.x.shape[0]
    act = (torch.ones((r,), dtype=torch.bool, device=dev) if active is None
           else active)
    t0 = (torch.full((r,), BIG, dtype=torch.float32, device=dev)
          if t_init is None else t_init)
    tb = torch.where(act, t0, torch.full_like(t0, -BIG))
    tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((r,), dtype=torch.float32, device=dev)
    v = torch.zeros((r,), dtype=torch.float32, device=dev)
    inv = [torch.where(c.abs() > 1e-20, 1.0 / c, torch.full_like(c, 1e20))
           for c in d]
    w_leaf = woop.view(-1, 8, 12)
    inf = float("inf")

    ray = act.nonzero().squeeze(1)
    node = torch.zeros_like(ray)
    while ray.numel():
        box = nodes[node].view(-1, 6, 8)
        ids = child_ids[node]
        oc = [c[ray][:, None] for c in o]
        ic = [c[ray][:, None] for c in inv]
        t1 = [(box[:, a] - oc[a]) * ic[a] for a in range(3)]
        t2 = [(box[:, 3 + a] - oc[a]) * ic[a] for a in range(3)]
        tmin = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]),
                                           torch.minimum(t1[1], t2[1])),
                             torch.minimum(t1[2], t2[2]))
        tmax = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]),
                                           torch.maximum(t1[1], t2[1])),
                             torch.maximum(t1[2], t2[2]))
        ok = ((tmax >= torch.clamp(tmin, min=TNEAR))
              & (tmin < tb[ray][:, None]) & (ids != 0))
        is_leaf = ids >= ni

        lp, lj = (ok & is_leaf).nonzero(as_tuple=True)
        if lp.numel():
            lray = ray[lp]
            leaf = (ids[lp, lj] - ni).to(torch.int64)
            w = w_leaf[leaf]                                # [Q, 8, 12]
            lo = [c[lray][:, None] for c in o]
            ld = [c[lray][:, None] for c in d]
            op = [w[..., 3 * a] * lo[0] + w[..., 3 * a + 1] * lo[1]
                  + w[..., 3 * a + 2] * lo[2] + w[..., 9 + a]
                  for a in range(3)]
            dp = [w[..., 3 * a] * ld[0] + w[..., 3 * a + 1] * ld[1]
                  + w[..., 3 * a + 2] * ld[2] for a in range(3)]
            tt = op[2] * (-1.0 / dp[2])
            uu = op[0] + tt * dp[0]
            vv = op[1] + tt * dp[1]
            hit = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                   & (tt > TNEAR) & (tt < tb[lray][:, None]))
            tq, sq = torch.where(hit, tt, inf).min(dim=1)   # lowest slot
            best = torch.full((r,), inf, dtype=torch.float32, device=dev)
            best.scatter_reduce_(0, lray, tq, "amin")
            win = (tq < inf) & (tq == best[lray])
            q = torch.arange(lray.numel(), device=dev)
            pick = torch.full((r,), lray.numel(), dtype=torch.int64,
                              device=dev)
            pick.scatter_reduce_(0, lray[win], q[win], "amin")
            rw = (pick < lray.numel()).nonzero().squeeze(1)
            qs = pick[rw]
            sqs = sq[qs]
            tb[rw] = tq[qs]
            tri[rw] = (leaf[qs] * 8 + sqs).to(torch.int32)
            u[rw] = uu[qs, sqs]
            v[rw] = vv[qs, sqs]

        ip, ij = (ok & ~is_leaf).nonzero(as_tuple=True)
        ray = ray[ip]
        node = ids[ip, ij].to(torch.int64)
    t = torch.where(act, tb, torch.zeros_like(tb))
    return Hit(t=t, tri=tri, u=u, v=v)
