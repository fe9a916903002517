"""Multi-device rendering over a 2-D mesh of processes.

Parity target: the JAX package's parallel/mesh.py (make_mesh :38,
render_sharded :439-506). There one program drives every device under
shard_map; here, in PyTorch's idiom, it is SPMD over torch.distributed:
one process per device, each running render_sharded.

- The mesh is dp (samples) x sp (pixels); rank r of the group sits at
  (r // sp, r % sp), row-major, as np.reshape(dp, sp) places devices.
- Each rank renders spp/dp samples from sample_offset = dpi*spp/dp over
  the pixels [spi*n/sp, (spi+1)*n/sp) through the engine's accumulate_*,
  keyed on their ids in the whole frame, so every (pixel, sample) draws
  the stream it draws on one device. Rays stay inside their rank.
- One all_reduce(SUM) of the linear frame and one of the int64 tallies
  per frame are the only communication (merge_samples,
  render_wavefront.cpp:319-358), both in the trace range
  "srt.ranks.reduce"; the tallies' copies to the device and back are
  waits of utils/profile.py:sync ("tallies"). Only the order of the
  float sums differs from one device, so a dp > 1 frame matches a
  single-device render to float noise with equal tallies, and a dp = 1
  frame bit for bit.
- Every rank builds the scene tables itself from the GLB bytes.

Both reductions run on the camera's device with the backend the caller
chose: NCCL on the rank's card; gloo on the CPU, or on a card that
several ranks share (NCCL refuses that), where gloo stages the CUDA
tensors through the host itself.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.profiler import record_function

from sycl_ray_tracer_torch.models.camera import Camera
from sycl_ray_tracer_torch.ops.vec import linear_to_gamma
from sycl_ray_tracer_torch.utils import profile as _profile


@dataclasses.dataclass(frozen=True)
class Mesh:
    """dp (sample shards) x sp (pixel shards) over the ranks of `group`
    (None: the default process group)."""

    dp: int
    sp: int
    group: object = None

    def coords(self) -> tuple:
        """(dpi, spi) of this process's rank."""
        r = dist.get_rank(self.group)
        return r // self.sp, r % self.sp


def make_mesh(dp: int | None = None, sp: int = 1, group=None) -> Mesh:
    """A mesh over the ranks of an initialized process group; dp
    defaults to all of them over sp. Every rank of the group takes part
    in each frame, so dp * sp must equal its size."""
    world = dist.get_world_size(group)
    if dp is None:
        dp = world // sp
    if dp < 1 or sp < 1 or dp * sp != world:
        raise ValueError(f"a {dp}x{sp} mesh needs {dp * sp} ranks; the "
                         f"process group has {world}")
    return Mesh(dp, sp, group)


def render_sharded(scene, cam: Camera, *, width: int, height: int,
                   spp: int, max_depth: int, seed: int = 0,
                   mesh: Mesh | None = None, renderer: str = "wavefront",
                   rr: bool = False):
    """Sharded render, called in every rank of the mesh. Returns, on
    every rank, (image [H, W, 3] float32 gamma-encoded on the camera's
    device, per-bounce ray counts [max_depth] int64 on the CPU, summed
    over the ranks)."""
    from sycl_ray_tracer_torch.models.megakernel import accumulate_megakernel
    from sycl_ray_tracer_torch.models.wavefront import accumulate_wavefront

    if mesh is None:
        mesh = make_mesh()
    n = width * height
    if spp % mesh.dp:
        raise ValueError(f"spp={spp} must divide by dp={mesh.dp}")
    if n % mesh.sp:
        raise ValueError(f"pixels={n} must divide by sp={mesh.sp}")
    engines = {"wavefront": accumulate_wavefront,
               "megakernel": accumulate_megakernel}
    if renderer not in engines:
        raise ValueError(f"unknown renderer {renderer!r}")
    dpi, spi = mesh.coords()
    n_local, spp_local = n // mesh.sp, spp // mesh.dp
    dev = cam.center.device
    lane = torch.arange(spi * n_local, (spi + 1) * n_local,
                        dtype=torch.int64, device=dev)
    acc, rays = engines[renderer](
        scene, cam, lane % width, lane // width, lane, spp=spp_local,
        max_depth=max_depth, seed=seed, sample_offset=dpi * spp_local, rr=rr)
    frame = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    frame[spi * n_local:(spi + 1) * n_local] = acc
    with _profile.sync("tallies"):
        rays = rays.to(dev)
    with record_function("srt.ranks.reduce"):
        dist.all_reduce(frame, dist.ReduceOp.SUM, group=mesh.group)
        dist.all_reduce(rays, dist.ReduceOp.SUM, group=mesh.group)
    img = linear_to_gamma(frame * (1.0 / spp))
    with _profile.sync("tallies"):
        rays = rays.cpu()
    return img.reshape(height, width, 3), rays


def _worker(rank: int, fn, world_size: int, backend: str, devices: list,
            init_method: str, args: tuple) -> None:
    device = torch.device(devices[rank])
    extra = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            extra["device_id"] = device
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **extra)
    try:
        fn(rank, device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str, device_of_rank,
          init_method: str, args: tuple = ()) -> None:
    """Run fn(rank, device, *args) in world_size new processes (the
    spawn start method), rank r on device_of_rank[r], all in one process
    group of `backend` ("nccl" or "gloo") that meets at init_method
    ("file://..." or "tcp://host:port"). A CPU rank runs one thread.
    Returns when every rank has ended; raises if any rank failed. fn
    must be importable by the children (a module-level function)."""
    import torch.multiprocessing as mp

    mp.spawn(_worker, args=(fn, world_size, backend, list(device_of_rank),
                            init_method, tuple(args)),
             nprocs=world_size, join=True)
