"""Time the traverse8, traverse5 and traverse1 kernels against variants
of themselves on one CUDA card, in one process, in turns.

    python3 kernel_ablation.py [--tree NAME=DIR ...] [--variants a,b,...]

Each variant is the checkout's csrc/ with one text patch (VARIANTS):
a design element of the kernels taken out (16-byte loads of nodes, of
leaves or of both, the compaction of live lanes, the reciprocal, the
single-push path), or a candidate (the stack in shared memory, a
prefetch of the next node, float2 leaf loads, register caps, other
block sizes, an L2 access-policy window over the first rows of
traverse5's node table). Each --tree NAME=DIR builds the csrc/ of
another checkout of this repository (for example the commit before,
unpacked with git archive) and times it as NAME, each kernel through
the C interface it had there: without scheduling scratch where its
source does not include schedule.cuh.

Every variant is built with the flags of ops/kernels.py into
build/ablation/<variant>/ and must return the checkout's hits bit for
bit. Timed on sponza_proc scale 2 (traverse8 on the SAH tree, traverse1
on the Morton heap of leaf size 4) and on minecraft_proc
--shared-instances (traverse5 in itf mode): 1M primary and 1M
first-bounce rays of the 1024x1024 frame, and the bounce rays tiled to
a megakernel wave of 8,388,608 lanes with all lanes and with 18 % live;
traverse5 in MT mode on the SAH tree of sponza_proc (its MT rows) at
the 1M primary and bounce rays of traverse8.
Each time is the mean of two runs of 10 launches, one in the order of
the variants and one in the reverse order; persisting L2 lines are
reset after each. Prints one line per measurement and a JSON object
last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import sys

import torch

import chip_smoke as cs

PKG_CSRC = os.path.join("sycl_ray_tracer_torch", "csrc")
OUT = os.path.join("build", "ablation")

_F4 = ("  const float4 v = __ldg(reinterpret_cast<const float4*>(p));\n"
       "  return F4{v.x, v.y, v.z, v.w};")
_I4 = ("  const int4 v = __ldg(reinterpret_cast<const int4*>(p));\n"
       "  return I4{v.x, v.y, v.z, v.w};")
_VEC_LEAF = "    if ((k & 3) == 0) {"
_STACK = "  srt::ArrayStack st;\n"
_RAYIO = "// A launch's rays (t_init may be null: BIG) and results."
# the first S stack entries of each thread in a column of shared memory
# (entry k at [k * B + thread]), the rest in local memory
_SHARED_STACK = """template <int S, int B>
struct SharedStack {
  int32_t* id;
  float* t;
  int32_t deep_id[SRT_STACK - S];
  float deep_t[SRT_STACK - S];
  __device__ __forceinline__ void put(int k, int32_t n, float tt) {
    if (k < S) {
      id[k * B] = n;
      t[k * B] = tt;
    } else {
      deep_id[k - S] = n;
      deep_t[k - S] = tt;
    }
  }
  __device__ __forceinline__ void get(int k, int32_t& n, float& tt) const {
    if (k < S) {
      n = id[k * B];
      tt = t[k * B];
    } else {
      n = deep_id[k - S];
      tt = deep_t[k - S];
    }
  }
};

"""
_SHARED_DECL = """  __shared__ int32_t stack_id[{s} * kThreads];
  __shared__ float stack_t[{s} * kThreads];
  srt::SharedStack<{s}, kThreads> st{{stack_id + threadIdx.x,
                                     stack_t + threadIdx.x}};
"""
_BOUNDS = "__launch_bounds__(kThreads)"
_THREADS = "constexpr int kThreads = 128;"
# heap leaves as nine 8-byte loads per two slots, in place of nine
# 16-byte loads per four (half the registers)
_FLOAT2 = """#ifdef __CUDA_ARCH__
    if ((k & 1) == 0) {
      for (int g = 0; g < k; g += 2) {
        float2 c[9];
        SRT_UNROLL
        for (int q = 0; q < 9; q++)
          c[q] = __ldg(reinterpret_cast<const float2*>(row + q * k + g));
        mt_slot(c[0].x, c[1].x, c[2].x, c[3].x, c[4].x, c[5].x, c[6].x,
                c[7].x, c[8].x, r, (int32_t)(leaf * k + g), tb, h);
        mt_slot(c[0].y, c[1].y, c[2].y, c[3].y, c[4].y, c[5].y, c[6].y,
                c[7].y, c[8].y, r, (int32_t)(leaf * k + g + 1), tb, h);
      }
      return;
    }
#endif
"""
# before a node's leaf tests, prefetch into L1 the row of its nearest
# entered internal child, the node popped next if it stays entered
_PREFETCH = """    uint32_t leaves = entered & is_leaf;
#ifdef __CUDA_ARCH__
    if (leaves != 0 && (entered & ~is_leaf) != 0) {
      float best = kBig;
      int32_t next = 0;
      SRT_UNROLL
      for (int j = 0; j < 8; j++) {
        if ((entered & ~is_leaf) >> j & 1u && tmin[j] <= best) {
          best = tmin[j];
          next = id[j];
        }
      }
      const float* p = nodes + (int64_t)next * 48;
      asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
      asm volatile("prefetch.global.L1 [%0];" ::"l"(p + 32));
    }
#endif
"""

# 16-byte loads done as four 4-byte ones, on the card only
_LD4S = """SRT_HD F4 ld4s(const float* p) {
#ifdef __CUDA_ARCH__
  return F4{__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
#else
  return ld4(p);
#endif
}

SRT_HD I4 ld4s(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return I4{__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
#else
  return ld4(p);
#endif
}

"""
_COMPONENT = "// Component j of v (j a compile-time constant after unrolling)."
_MT_ROWS = "// The 8 slots of row `row` of mt"
# persistent warps over every lane, each lane reading its own flag of
# the mask (passed in place of the list of live lanes)
_LIST_INDEX = "    const int64_t i = list == nullptr ? k : (int64_t)list[k];\n"
_MASK_INDEX = """    const int64_t i = k;
    if (list != nullptr && reinterpret_cast<const uint8_t*>(list)[i] == 0) {
      io.t[i] = 0.0f;
      io.tri[i] = -1;
      io.u[i] = 0.0f;
      io.v[i] = 0.0f;
      continue;
    }
"""
_COMPACT = """  if (active != nullptr) {
    err = srt::compact_lanes((const uint8_t*)active, n_rays, (int32_t*)list,
                             cnt, (float*)t_out, (int32_t*)tri_out,
                             (float*)u_out, (float*)v_out, s);
    if (err != cudaSuccess) return (int)err;
  }
"""
_COUNT = "const int64_t n = list == nullptr ? n_rays : (int64_t)counters[0];"
_PASS_LIST = "active == nullptr ? nullptr : (const int32_t*)list"
_NO_COMPACTION = [(f, old, new) for f in ("traverse8.cu", "traverse5.cu",
                                          "traverse1.cu")
                  for old, new in ((_COMPACT, ""),
                                   (_COUNT, "const int64_t n = n_rays;"),
                                   (_PASS_LIST, "(const int32_t*)active"))]
# traverse5's launch with an L2 access-policy window over the first
# min(cap, set-aside, table) bytes of its node table (the global tree's
# top levels come first), persisting; the set-aside is the most the
# card allows
_L2_WINDOW = """cudaAccessPolicyWindow node_window(const void* nodes, int32_t ni) {
  static size_t aside = 0;
  if (aside == 0) {
    int dev = 0, most = 0, window = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxPersistingL2CacheSize, dev);
    cudaDeviceGetAttribute(&window, cudaDevAttrMaxAccessPolicyWindowSize,
                           dev);
    aside = (size_t)(most < window ? most : window);
    cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, aside);
  }
  size_t bytes = (size_t)ni * 48 * sizeof(float);
  const size_t cap = (size_t){mb} << 20;
  bytes = bytes < cap ? bytes : cap;
  bytes = bytes < aside ? bytes : aside;
  cudaAccessPolicyWindow w = {};
  w.base_ptr = const_cast<void*>(nodes);
  w.num_bytes = bytes;
  w.hitRatio = 1.0f;
  w.hitProp = cudaAccessPropertyPersisting;
  w.missProp = cudaAccessPropertyStreaming;
  return w;
}

template <class Leaf>
cudaError_t launch("""
_T5_LAUNCH = "  traverse5_kernel<Leaf><<<grid, kThreads, 0, s>>>("
_T5_LAUNCH_EX = """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeAccessPolicyWindow;
  attr[0].val.accessPolicyWindow = node_window(nodes, ni);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, traverse5_kernel<Leaf>,"""


def _l2_window(mb: int) -> list:
    return [("traverse5.cu", "template <class Leaf>\ncudaError_t launch(",
             _L2_WINDOW.replace("{mb}", str(mb))),
            ("traverse5.cu", _T5_LAUNCH, _T5_LAUNCH_EX)]


_ALL_CU = ("traverse8.cu", "traverse5.cu", "traverse1.cu")

# variant -> [(file in csrc, text, replacement)]
VARIANTS = {
    "checkout": [],
    "scalar_loads": [
        ("walk_regs.cuh", _F4,
         "  return F4{__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};"),
        ("walk_regs.cuh", _I4,
         "  return I4{__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};")],
    "node_scalar_loads": [
        ("walk_regs.cuh", "const F4 v = ld4(row + 4 * q);",
         "const F4 v = ld4s(row + 4 * q);"),
        ("walk_regs.cuh", "const I4 a = ld4(kids.ids", "const I4 a = ld4s(kids.ids"),
        ("walk_regs.cuh", "const I4 b = ld4(kids.ids", "const I4 b = ld4s(kids.ids"),
        ("walk_regs.cuh", _COMPONENT, _LD4S + _COMPONENT)],
    "leaf5_scalar_loads": [
        ("traverse5.cuh", "ld4(", "ld4s("),
        ("traverse5.cuh", _MT_ROWS, _LD4S + _MT_ROWS)],
    "leaf5_group_loop": [
        ("traverse5.cuh", "  SRT_UNROLL\n  for (int g = 0; g < 8; g += 4",
         "  _Pragma(\"unroll 1\")\n  for (int g = 0; g < 8; g += 4")],
    "no_compaction": [("schedule.cuh", _LIST_INDEX, _MASK_INDEX)]
    + _NO_COMPACTION,
    "l2_window_8mb": _l2_window(8),
    "l2_window_max": _l2_window(1 << 12),
    "shared_stack": [
        ("schedule.cuh", _RAYIO, _SHARED_STACK + _RAYIO),
        ("traverse8.cu", _STACK, _SHARED_DECL.format(s=16)),
        ("traverse1.cu", _STACK, _SHARED_DECL.format(s=24))],
    "division": [
        ("traverse8.cuh", "return -__frcp_rn(x);", "return -1.0f / x;")],
    "heap_leaf_scalar": [
        ("traverse1.cuh", "if ((k & 3) == 0) {", "if (false) {")],
    "heap_leaf_float2": [
        ("traverse1.cuh", _VEC_LEAF, _FLOAT2 + _VEC_LEAF)],
    "push_rank_only": [
        ("walk_regs.cuh", "if ((m & (m - 1)) == 0) {", "if (false) {")],
    "prefetch_next": [
        ("walk_regs.cuh", "    uint32_t leaves = entered & is_leaf;\n",
         _PREFETCH)],
    "block_64": [(f, _THREADS, "constexpr int kThreads = 64;")
                 for f in _ALL_CU],
    "block_256": [(f, _THREADS, "constexpr int kThreads = 256;")
                  for f in _ALL_CU],
    "min_blocks_4": [(f, _BOUNDS, "__launch_bounds__(kThreads, 4)")
                     for f in _ALL_CU],
    "min_blocks_6": [(f, _BOUNDS, "__launch_bounds__(kThreads, 6)")
                     for f in _ALL_CU],
    "min_blocks_8": [(f, _BOUNDS, "__launch_bounds__(kThreads, 8)")
                     for f in _ALL_CU],
}
KERNELS = ("traverse8", "traverse5", "traverse1")


def log(msg: str) -> None:
    print(msg, flush=True)


def build(variants: dict, trees: dict) -> dict:
    """Patched copies of csrc/, and the csrc/ of each other checkout in
    trees {name: dir}, built in parallel: {name: library path}."""
    from sycl_ray_tracer_torch.ops import kernels

    nvcc = kernels._nvcc()
    srcs, cmds, links = {}, [], []
    for name, patches in variants.items():
        src = os.path.join(OUT, name, "csrc")
        shutil.rmtree(os.path.join(OUT, name), ignore_errors=True)
        shutil.copytree(PKG_CSRC, src)
        for fname, old, new in patches:
            path = os.path.join(src, fname)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise RuntimeError(f"variant {name}: {fname} has no {old!r}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        srcs[name] = src
    for name, tree in trees.items():
        src = os.path.join(OUT, name, "csrc")
        shutil.rmtree(os.path.join(OUT, name), ignore_errors=True)
        shutil.copytree(os.path.join(tree, PKG_CSRC), src)
        srcs[name] = src
    out = {}
    for name, src in srcs.items():
        # a tree from before a source was added builds without it
        sources = [s for s in kernels.CUDA_SOURCES
                   if os.path.exists(os.path.join(src, s))]
        objs = [os.path.join(src, f"{s}.o") for s in sources]
        cmds += [[nvcc] + kernels.NVCC_FLAGS + ["-c", "-I", src, "-o", obj,
                                                os.path.join(src, s)]
                 for s, obj in zip(sources, objs)]
        lib = os.path.join(OUT, name, "kernels.so")
        links.append([nvcc] + kernels.ARCH + ["-shared", "-o", lib] + objs)
        out[name] = lib
    report = kernels._run_all(cmds)
    kernels._run_all(links)
    variant = kernel = None
    for line in report.splitlines():
        if line.startswith(nvcc):
            variant = line.split(OUT + os.sep)[1].split(os.sep)[0]
        m = re.search(r"(traverse\d_kernel|compact_lanes_kernel)", line)
        if m:
            kernel = m.group(1)
        if "registers" in line or "stack frame" in line:
            log(f"[build] {variant} {kernel}: {line.strip()}")
    return out


class Variant:
    """One built library and a launch of each of its kernels."""

    def __init__(self, name: str, lib_path: str):
        from sycl_ray_tracer_torch.ops import kernels

        self.name = name
        self.lib = ctypes.CDLL(lib_path)
        # a kernel from before the scheduling scratch takes none; its
        # source does not include schedule.cuh
        csrc = os.path.join(os.path.dirname(lib_path), "csrc")
        self.scratch = set()
        for k in KERNELS:
            with open(os.path.join(csrc, f"{k}.cu")) as f:
                if '#include "schedule.cuh"' in f.read():
                    self.scratch.add(k)
            tail = [kernels._I64] + ([kernels._P] * 3 if k in self.scratch
                                     else [kernels._P])
            fn = getattr(self.lib, f"srt_{k}")
            fn.argtypes = kernels._TABLES[k] + [kernels._P] * 12 + tail
            fn.restype = ctypes.c_int

    def launch(self, name: str, tables: list, o, d, active=None):
        from sycl_ray_tracer_torch.ops.intersect import Hit

        r = o.x.shape[0]
        dev = o.x.device
        out = [torch.empty((r,), dtype=dt, device=dev)
               for dt in (torch.float32, torch.int32, torch.float32,
                          torch.float32)]
        args = [x if x is None or isinstance(x, int) else x.data_ptr()
                for x in tables]
        extra = []
        if name in self.scratch:
            lanes = (None if active is None else
                     torch.empty((r,), dtype=torch.int32, device=dev))
            counters = torch.zeros((2,), dtype=torch.int64, device=dev)
            extra = [None if lanes is None else lanes.data_ptr(),
                     counters.data_ptr()]
        err = getattr(self.lib, f"srt_{name}")(
            *args, *(c.data_ptr() for c in (*o, *d)),
            None if active is None else active.data_ptr(), None,
            *(x.data_ptr() for x in out), r, *extra,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} {name}: CUDA error {err}")
        return Hit(*out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: another checkout of this repository")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS")
    args = ap.parse_args()

    from sycl_ray_tracer_torch.ops.vec import V3
    from sycl_ray_tracer_torch.utils.cli import resolve_scene_bytes
    from sycl_ray_tracer_torch.utils.fixtures import load_pair

    smi = cs.phase_device()
    names = args.variants.split(",")
    trees = dict(t.split("=", 1) for t in args.tree)
    libs = build({n: VARIANTS[n] for n in names}, trees)
    variants = [Variant(n, lib) for n, lib in libs.items()]

    cuda = torch.device("cuda")
    glb = resolve_scene_bytes("sponza_proc")
    sah, cam, host = cs.load(glb, 1024, 1024, cuda)
    heap, _, hcam = load_pair(glb, 1024, 1024, leaf_size=4, device=cuda)
    inst, icam, _ = cs.load(resolve_scene_bytes("minecraft_proc"), 1024,
                            1024, cuda, shared_instances=True)
    cases = {}
    gen = torch.Generator(device="cpu").manual_seed(23)
    live18 = (torch.rand(cs.WAVE_LANES, generator=gen) < 0.18).to(cuda)
    mt = cs.sah_mt_rows(host, cuda)
    # (kernel, label, scene, camera, MT rows, with the waves)
    for k, name, scene, c, rows, waves in (
            ("traverse8", "traverse8", sah, cam, None, True),
            ("traverse1", "traverse1", heap, hcam, None, True),
            ("traverse5", "traverse5 itf", inst, icam, None, True),
            ("traverse5", "traverse5 MT", sah, cam, mt, False)):
        tables = cs.kernel_tables(k, scene, rows)
        prim, bounce = cs.make_rays(scene, c, 1024, 1024, 1 << 20)
        cases[f"{name} primary 1M"] = (k, tables, *prim, None)
        cases[f"{name} bounce 1M"] = (k, tables, *bounce, None)
        if not waves:
            continue
        tile = cs.WAVE_LANES // bounce[0].x.shape[0]
        wave = tuple(V3(*(x.repeat(tile) for x in v)) for v in bounce)
        cases[f"{name} wave all live"] = (k, tables, *wave,
                                          torch.ones_like(live18))
        cases[f"{name} wave 18% live"] = (k, tables, *wave, live18)

    # persisting L2 lines (the l2_window variants) are reset after each
    # variant's launches, so that they favour no other variant
    libcuda = ctypes.CDLL("libcuda.so.1")

    def reset_l2():
        torch.cuda.synchronize()
        err = libcuda.cuCtxResetPersistingL2Cache()
        if err != 0:
            raise RuntimeError(f"cuCtxResetPersistingL2Cache: error {err}")

    ref = variants[0]
    for label, (k, tables, o, d, act) in cases.items():
        want = ref.launch(k, tables, o, d, act)
        for v in variants[1:]:
            got = v.launch(k, tables, o, d, act)
            reset_l2()
            if not all(torch.equal(a, b) for a, b in zip(want, got)):
                raise AssertionError(f"{v.name} differs from {ref.name} on "
                                     f"{label}")
    log(f"[check] every variant returns {ref.name}'s hits bit for bit")

    times = {v.name: {} for v in variants}
    for order in (variants, variants[::-1]):
        for label, (k, tables, o, d, act) in cases.items():
            for v in order:
                ms = cs.time_ms(lambda: v.launch(k, tables, o, d, act), 10)
                reset_l2()
                times[v.name].setdefault(label, []).append(ms)
    result = {}
    for v in variants:
        result[v.name] = {label: sum(r) / len(r)
                          for label, r in times[v.name].items()}
        for label, r in times[v.name].items():
            log(f"[time] {v.name} {label} on {smi}: {sum(r) / len(r):.4f} ms "
                f"(runs {', '.join(f'{x:.4f}' for x in r)})")
    print(json.dumps({"device": smi, "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
