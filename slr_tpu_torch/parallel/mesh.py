"""Rendering over the ranks of a process group (counterpart of
slr_tpu/parallel/mesh.py).

The reference lays pixel shards over a device mesh with `shard_map` and
reduces with `psum` / gathers; here every rank is one process (torchrun,
`parallel/distributed.py`) and the collectives are torch.distributed's:

* `render_sharded`: the fixed-depth path tracer with pixels split into one
  contiguous shard per rank (padded with inert lanes), then one
  `all_gather` of the shards' films;
* `render_wavefront_sharded`: the shipped wavefront scheduler, each rank
  draining the contiguous work range [rank * per, (rank + 1) * per) with
  its own lanes and full-frame film, then one `all_reduce(SUM)`;
* `render_bpt_sharded`: BPT with eye pixels sharded; every rank keeps a
  full-frame film for the t = 1 splats, then one `all_reduce(SUM)`.

Random streams are keyed by (pixel, sample), so every work item's estimate
is the single-process one whatever the rank count; only the films' sum
order differs. A `Mesh` without a process group is a world of one, in
which every collective is the identity, so the sharded functions also run
in-process. Under gloo, collectives on CUDA tensors go through the host.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..core.device import resolve_device
from ..scene.types import FlatScene

Tensor = torch.Tensor

# Collectives since the last reset: calls, bytes sent per rank, and (while
# `track_collectives(True)`) their seconds, each bracketed by device syncs.
COLLECTIVES = {"calls": 0, "bytes": 0, "seconds": 0.0}
_TIMED = [False]


def reset_collectives() -> None:
    COLLECTIVES.update(calls=0, bytes=0, seconds=0.0)


def track_collectives(on: bool) -> None:
    """Time every collective (a device sync before and after each)."""
    _TIMED[0] = bool(on)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a sharded render runs over: this process's rank, the
    world size, its device, and the process group (None: a world of one)."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    group: object = None
    backend: str | None = None

    def _run(self, x: Tensor, fn) -> Tensor:
        COLLECTIVES["calls"] += 1
        COLLECTIVES["bytes"] += x.numel() * x.element_size()
        timed = _TIMED[0]
        if timed:
            _sync(x.device)
            t0 = time.perf_counter()
        # gloo reduces host tensors: CUDA tensors go through the host.
        host = self.backend == "gloo" and x.device.type == "cuda"
        y = fn(x.cpu() if host else x.contiguous())
        if host:
            y = y.to(x.device)
        if timed:
            _sync(x.device)
            COLLECTIVES["seconds"] += time.perf_counter() - t0
        return y

    def all_reduce(self, x: Tensor, op: str = "sum") -> Tensor:
        """The elementwise reduction of `x` over the ranks ("sum", "min" or
        "max"), as a new tensor."""
        if self.group is None:
            return x
        import torch.distributed as dist

        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]

        def fn(y):
            y = y.clone()
            dist.all_reduce(y, op=red, group=self.group)
            return y

        return self._run(x, fn)

    def all_gather(self, x: Tensor) -> Tensor:
        """Every rank's `x` (equal shapes), concatenated along dim 0 in
        rank order."""
        if self.group is None:
            return x
        import torch.distributed as dist

        def fn(y):
            parts = [torch.empty_like(y) for _ in range(self.size)]
            dist.all_gather(parts, y, group=self.group)
            return torch.cat(parts)

        return self._run(x, fn)

    def barrier(self) -> None:
        """Wait for every rank (one small all-reduce on the mesh device)."""
        self.all_reduce(torch.zeros(1, device=self.device))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_mesh(device=None) -> Mesh:
    """The world this process belongs to: the default process group when
    torch.distributed is initialized (`init_distributed`), else a world of
    one. `device` defaults to the device `init_distributed` bound, else the
    CUDA device."""
    import torch.distributed as dist

    from .distributed import bound_device

    if device is None:
        device = bound_device()
    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(device=dev)
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size(), device=dev,
                group=dist.group.WORLD, backend=dist.get_backend())


def _film_channels(scene: FlatScene) -> int:
    from ..spectrum.spectral import NUM_STRATA

    return NUM_STRATA if scene.stex.spectral else scene.stex.value.shape[-1]


# Lanes a rank traces at once, as `render` and `render_bpt` batch them.
RAY_BATCH = 65536


def _shard_film_pass(scene: FlatScene, pixel_id: Tensor, sample_id: Tensor,
                     width: int, height: int, seed, max_depth: int) -> Tensor:
    """One sample pass over a pixel shard -> its film contribution (R, S):
    RGB channels or spectral strata, as `render/pt.py` `render_batch` gives
    them, in batches of at most RAY_BATCH lanes."""
    from ..render.pt import render_batch

    parts = [render_batch(scene, pixel_id[b:b + RAY_BATCH],
                          sample_id[b:b + RAY_BATCH], seed, width, height,
                          max_depth)
             for b in range(0, pixel_id.shape[0], RAY_BATCH)]
    return torch.cat(parts)


def _pixel_shard(n_pix: int, mesh: Mesh) -> tuple[Tensor, Tensor, int]:
    """This rank's lanes of the padded pixel range: (pixel ids, in-image
    mask, lanes per rank). Padding lanes re-trace pixel 0."""
    per = -(-n_pix // mesh.size)
    ids = torch.arange(mesh.rank * per, (mesh.rank + 1) * per,
                       device=mesh.device)
    inside = ids < n_pix
    return torch.where(inside, ids, 0), inside, per


def render_sharded(scene: FlatScene, width: int, height: int, spp: int,
                   mesh: Mesh, seed: int = 0, max_depth: int = 16) -> Tensor:
    """The fixed-depth path tracer with pixels sharded over the ranks.
    Returns the (H, W, S) linear mean film on every rank: RGB channels, or
    a spectral scene's strata. Each rank traces its contiguous pixel shard
    in batches of at most 65,536 lanes, and one `all_gather` assembles the
    image. Pixel counts that do not divide the ranks are padded with inert
    lanes."""
    scene = scene.to(mesh.device)
    n_pix = width * height
    pixel_id, _, per = _pixel_shard(n_pix, mesh)
    film = None
    for i in range(spp):
        sample_id = torch.full((per,), i, dtype=torch.int64,
                               device=mesh.device)
        out = _shard_film_pass(scene, pixel_id, sample_id, width, height,
                               seed, max_depth)
        film = out if film is None else film + out
    film = mesh.all_gather(film / spp)
    return film[:n_pix].reshape(height, width, _film_channels(scene))


def render_wavefront_sharded(scene: FlatScene, width: int, height: int,
                             spp: int, mesh: Mesh, seed: int = 0,
                             max_depth: int | None = None,
                             sample_offset: int = 0,
                             return_iters: bool = False):
    """The shipped persistent-wavefront scheduler over the ranks. The
    (pixel, sample) work space is split into one contiguous range per rank;
    each rank drains its range with its own work queue, lanes and
    full-frame film, and the films reduce with one `all_reduce(SUM)`.
    Returns the (H, W, 3) mean linear radiance on every rank (and this
    rank's iteration count when `return_iters`)."""
    from ..render.wavefront import (
        DEFAULT_LANE_CAP,
        DEFAULT_MAX_DEPTH,
        _run_wavefront,
    )
    from ..spectrum.spectral import strata_to_rgb

    if max_depth is None:
        max_depth = DEFAULT_MAX_DEPTH
    scene = scene.to(mesh.device)
    n_pix = width * height
    total = spp * n_pix
    per = -(-total // mesh.size)
    lanes = min(per, n_pix, DEFAULT_LANE_CAP)
    lo = mesh.rank * per
    film, n_iters = _run_wavefront(
        scene, n_pix, spp + sample_offset, seed, width, height,
        sample_offset, max_depth, n_lanes=lanes, work_lo=lo,
        work_hi=lo + per)
    film = mesh.all_reduce(film)
    img = (film / spp).reshape(height, width, -1)
    if scene.stex.spectral:
        img = strata_to_rgb(img)
    return (img, n_iters) if return_iters else img


def render_bpt_sharded(scene: FlatScene, width: int, height: int, spp: int,
                       mesh: Mesh, seed: int = 0, max_light_verts: int = 8,
                       max_eye_verts: int = 8) -> Tensor:
    """BPT at flat subpath caps with eye pixels sharded over the ranks and
    every rank's full-frame film (its own pixels and its t = 1 splats)
    reduced by one `all_reduce(SUM)`. A rank's shard runs in batches of at
    most 65,536 lanes; padding lanes carry `lane_mask=False`, so they add
    nothing. Returns the (H, W, S) linear mean film: RGB channels, or a
    spectral scene's strata."""
    from ..render.bpt import bpt_batch

    scene = scene.to(mesh.device)
    n_pix = width * height
    s = _film_channels(scene)
    pixel_id, inside, per = _pixel_shard(n_pix, mesh)
    film = torch.zeros((n_pix, s), dtype=torch.float32, device=mesh.device)
    for i in range(spp):
        for b in range(0, per, RAY_BATCH):
            pid = pixel_id[b:b + RAY_BATCH]
            mask = inside[b:b + RAY_BATCH]
            full = mesh.rank * per + b + pid.shape[0] <= n_pix
            sample_id = torch.full(pid.shape, i,
                                   dtype=torch.int64, device=mesh.device)
            film = bpt_batch(scene, pid, sample_id, seed, width, height,
                             film, max_light_verts, max_eye_verts,
                             pid_contiguous=full,
                             lane_mask=None if full else mask)
    film = mesh.all_reduce(film)
    return (film / spp).reshape(height, width, s)


def dryrun(n_ranks: int | None = None, device=None) -> None:
    """Run every sharded renderer once at tiny shapes on this process's
    world and check their shapes: RGB and spectral PT, BPT with reduced
    splats, the sharded wavefront, and the scene-sharded PT."""
    from ..scene.presets import cornell_box_spheres
    from ..spectrum.spectral import NUM_STRATA
    from .scene_shard import render_pt_scene_sharded

    mesh = make_mesh(device)
    if n_ranks is not None and mesh.size != n_ranks:
        raise RuntimeError(f"dryrun({n_ranks}) runs in a world of "
                           f"{mesh.size}")
    scene = cornell_box_spheres(sphere_res=6, device="cpu")
    spec = cornell_box_spheres(sphere_res=6, spectral=True, device="cpu")
    img = render_sharded(scene, 32, 24, spp=1, mesh=mesh, max_depth=3)
    assert img.shape == (24, 32, 3)
    img_s = render_sharded(spec, 20, 10, spp=1, mesh=mesh, max_depth=3)
    assert img_s.shape == (10, 20, NUM_STRATA)
    img_b = render_bpt_sharded(scene, 16, 12, spp=1, mesh=mesh,
                               max_light_verts=3, max_eye_verts=3)
    assert img_b.shape == (12, 16, 3)
    img_w = render_wavefront_sharded(spec, 20, 10, spp=2, mesh=mesh)
    assert img_w.shape == (10, 20, 3)
    img_ss = render_pt_scene_sharded(scene, mesh, 16, 12, spp=1,
                                     max_depth=3)
    assert img_ss.shape == (12, 16, 3)
    for name, x in (("PT rgb", img), ("PT spectral", img_s), ("BPT", img_b),
                    ("wavefront", img_w), ("scene-sharded PT", img_ss)):
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"dryrun: {name} is not finite")
        if mesh.rank == 0:
            print(f"dryrun {name} ok on {mesh.size} ranks; "
                  f"mean={float(x.mean()):.5f}")
