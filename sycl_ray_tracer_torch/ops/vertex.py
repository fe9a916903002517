"""The bounce stages by hand: one shade launch and one scatter launch a
bounce (csrc/vertex.cu; the per-lane code is csrc/vertex.cuh).

- shade(scene, hit) -> rec [12, N] f32: for each hit lane the unit
  normal, the albedo with the texel applied, the emission, and the
  material's type (as a float), roughness and IOR, one row each
  (csrc/vertex.cuh ShadeRec); a miss lane's column is left unwritten.
- scatter(...): the material's scatter, russian roulette and the
  termination algebra of one engine's bounce, on the records. The
  megakernel's form (state=, key=) updates its PathState in place and
  returns it; the wavefront's form (q=, q_id=, lane=, seed=,
  sample_offset=) keys each lane in the kernel and returns (out [9, N]:
  new direction, attenuation and radiance, terminated [N] bool,
  contrib [N, 3]).

Each adapts to what it is given, with one code path: a scene with or
without instances (inst_nmat) or textures, int32 or int64 hit ids, the
lane's material type, and russian roulette (rr, from bounce rr_start).
The bounce counter and rr are arguments of the launch, never tensors
uploaded from the host.

On CUDA tensors each wrapper checks its inputs, allocates its outputs
with torch.empty, launches on the current stream and raises if the
launch reports a CUDA error; shade.launches and scatter.launches count
the launches. On CPU tensors it runs the g++ build of the same per-lane
code (csrc/vertex_host.cpp), the tests' view of the kernels. The engines
call these only on the card: on the CPU they run the plain torch stages
of models/trace.py and models/wavefront.py, the reference.
"""

from __future__ import annotations

import ctypes

import torch

from sycl_ray_tracer_torch.ops import kernels

REC_ROWS = 12

_P = ctypes.c_void_p
_MASK = 0xFFFFFFFF


class _ShadeTables(ctypes.Structure):
    _fields_ = [("shade_tbl", _P), ("inst_nmat", _P), ("mat_type", _P),
                ("mat_albedo", _P), ("mat_tex", _P), ("mat_rough", _P),
                ("mat_ior", _P), ("mat_emissive", _P), ("tex_packed", _P),
                ("inst_s8", ctypes.c_int64), ("tex_res", ctypes.c_int32),
                ("pad_", ctypes.c_int32)]


class _Bounce(ctypes.Structure):
    _fields_ = [("rec", _P), ("hit_t", _P), ("miss", _P), ("sky", _P),
                ("n", ctypes.c_int64), ("counter", ctypes.c_uint32),
                ("rr", ctypes.c_int32), ("rr_start", ctypes.c_int32),
                ("pad_", ctypes.c_int32)]


class _QueueIO(ctypes.Structure):
    _fields_ = [("q", _P), ("q_id", _P), ("lane", _P),
                ("n_pix", ctypes.c_int64), ("sample_offset", ctypes.c_int64),
                ("out", _P), ("terminated", _P), ("contrib", _P),
                ("seed", ctypes.c_uint32), ("pad_", ctypes.c_int32)]


class _PathIO(ctypes.Structure):
    _fields_ = [("col", _P * 15), ("done", _P), ("key", _P)]


def _tables(scene, dev) -> _ShadeTables:
    """The scene's shading tables, checked: shade_tbl is read with
    16-byte loads."""
    lk = scene.shade_tbl.shape[0]
    kernels.check("shade_tbl", scene.shade_tbl, torch.float32, (lk, 16), dev)
    kernels.check_aligned("shade_tbl", scene.shade_tbl)
    m = scene.mat_type.shape[0]
    for name, dtype, shape in (("mat_type", torch.int64, (m,)),
                               ("mat_albedo", torch.float32, (m, 3)),
                               ("mat_tex", torch.int64, (m,)),
                               ("mat_rough", torch.float32, (m,)),
                               ("mat_ior", torch.float32, (m,)),
                               ("mat_emissive", torch.float32, (m, 3))):
        kernels.check(name, getattr(scene, name), dtype, shape, dev)
    nmat = tex = None
    if scene.has_instances:
        nmat = scene.inst_nmat
        kernels.check("inst_nmat", nmat, torch.float32, (nmat.shape[0], 9),
                      dev)
    if scene.has_textures:
        tex = scene.tex_packed
        kernels.check("tex_packed", tex, torch.int32, (tex.shape[0],), dev)
    p = kernels._ptr
    return _ShadeTables(p(scene.shade_tbl), p(nmat), p(scene.mat_type),
                        p(scene.mat_albedo), p(scene.mat_tex),
                        p(scene.mat_rough), p(scene.mat_ior),
                        p(scene.mat_emissive), p(tex),
                        int(scene.inst_s8) if nmat is not None else 0,
                        int(scene.tex_res), 0)


def shade(scene, hit) -> torch.Tensor:
    """The shading records [12, N] of the N lanes of `hit` (ids in the
    shading tables' slots, -1 on a miss; int32 or int64)."""
    dev = kernels.entry_device(hit.t)
    n = hit.t.shape[0]
    if hit.tri.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"tri: expected int32 or int64, got {hit.tri.dtype}")
    kernels.check("tri", hit.tri, hit.tri.dtype, (n,), dev)
    for name, c in (("t", hit.t), ("u", hit.u), ("v", hit.v)):
        kernels.check(name, c, torch.float32, (n,), dev)
    tables = _tables(scene, dev)
    rec = torch.empty((REC_ROWS, n), dtype=torch.float32, device=dev)
    kernels.call("shade", dev, ctypes.byref(tables), hit.tri.data_ptr(),
                 hit.tri.element_size(), hit.u.data_ptr(), hit.v.data_ptr(),
                 rec.data_ptr(), n)
    if dev.type == "cuda":
        shade.launches += 1
    return rec


shade.launches = 0


def scatter(scene, rec: torch.Tensor, hit_t: torch.Tensor,
            miss: torch.Tensor, counter: int, *, rr: bool = False,
            rr_start: int = 0, state=None, key=None, q=None, q_id=None,
            lane=None, seed: int = 0, sample_offset: int = 0):
    """One bounce's scatter stage over the N lanes of rec [12, N] (from
    shade), with the hits' t [N] and miss mask [N], draw counter
    `counter` (bounce + 2), and russian roulette when rr and counter - 2
    >= rr_start. The megakernel's form takes state (PathState of [N]
    columns, each a tensor of its own) and key [N] int64 and returns
    state, updated in place; the wavefront's takes the queue q [12, N]
    (o, d, att, rad), q_id [N] int64, the pixels' keys lane [R] int64,
    seed and sample_offset, and returns (out [9, N], terminated [N] bool,
    contrib [N, 3])."""
    if (state is None) == (q is None):
        raise ValueError("scatter takes either state and key (megakernel) "
                         "or q, q_id and lane (wavefront)")
    dev = kernels.entry_device(rec)
    n = rec.shape[1] if rec.dim() == 2 else -1
    kernels.check("rec", rec, torch.float32, (REC_ROWS, n), dev)
    kernels.check("hit_t", hit_t, torch.float32, (n,), dev)
    kernels.check("miss", miss, torch.bool, (n,), dev)
    kernels.check("sky_color", scene.sky_color, torch.float32, (3,), dev)
    bounce = _Bounce(rec.data_ptr(), hit_t.data_ptr(), miss.data_ptr(),
                     scene.sky_color.data_ptr(), n, counter & _MASK,
                     int(bool(rr)), int(rr_start), 0)
    if state is not None:
        cols = [c for v in (state.o, state.d, state.att, state.rad,
                            state.result) for c in v]
        for c in cols:
            kernels.check("state", c, torch.float32, (n,), dev)
        ptrs = sorted(c.data_ptr() for c in cols)
        if any(b - a < 4 * n for a, b in zip(ptrs, ptrs[1:])):
            raise ValueError("state columns must not overlap: the stage "
                             "updates them in place")
        kernels.check("done", state.done, torch.bool, (n,), dev)
        kernels.check("key", key, torch.int64, (n,), dev)
        io = _PathIO((_P * 15)(*(c.data_ptr() for c in cols)),
                     state.done.data_ptr(), key.data_ptr())
        kernels.call("scatter_paths", dev, ctypes.byref(bounce),
                     ctypes.byref(io))
        result = state
    else:
        kernels.check("q", q, torch.float32, (12, n), dev)
        kernels.check("q_id", q_id, torch.int64, (n,), dev)
        kernels.check("lane", lane, torch.int64, (lane.shape[0],), dev)
        if n and not lane.shape[0]:
            raise ValueError("lane: a queue needs its pixels' keys")
        out = torch.empty((9, n), dtype=torch.float32, device=dev)
        terminated = torch.empty((n,), dtype=torch.bool, device=dev)
        contrib = torch.empty((n, 3), dtype=torch.float32, device=dev)
        io = _QueueIO(q.data_ptr(), q_id.data_ptr(), lane.data_ptr(),
                      lane.shape[0], sample_offset, out.data_ptr(),
                      terminated.data_ptr(), contrib.data_ptr(),
                      seed & _MASK, 0)
        kernels.call("scatter_queue", dev, ctypes.byref(bounce),
                     ctypes.byref(io))
        result = out, terminated, contrib
    if dev.type == "cuda":
        scatter.launches += 1
    return result


scatter.launches = 0
