"""One rank of a gloo world on the CPU, for the port's sharded tests.

    python tests/torch_dist_worker.py JOB.pkl OUT_DIR

with RANK, WORLD_SIZE and LOCAL_RANK in the environment, as torchrun sets
them. JOB.pkl holds {"init": a "file://" store, "jobs": [(name, kwargs),
...]}; the rank joins the world through `init_distributed`, runs each job
on it, and writes its results, as numpy, to OUT_DIR/rank<RANK>.pkl.
Imports no JAX: the reference runs in the test process. `run_ranks`
starts the world and returns every rank's results."""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _numpy(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _numpy(v) for k, v in zip(x._fields, x)}
    if isinstance(x, (tuple, list)):
        return type(x)(_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    return x


def _jobs():
    import torch

    from slr_tpu_torch.parallel import mesh as pm
    from slr_tpu_torch.parallel import scene_shard as ss
    from slr_tpu_torch.render.wavefront import _run_wavefront

    def cast(mesh, scene, o, d, tmin, tmax, active=None):
        hit = ss.intersect_scene_sharded(
            scene, mesh, torch.as_tensor(o), torch.as_tensor(d), tmin, tmax,
            None if active is None else torch.as_tensor(active))
        return hit._replace(inst=None)

    def occluded(mesh, scene, o, d, tmin, tmax):
        return ss.occluded_scene_sharded(scene, mesh, torch.as_tensor(o),
                                         torch.as_tensor(d), tmin, tmax)

    def shard(mesh, scene):
        sh = ss.shard_scene(scene, mesh)
        return dict(bytes=sh.bytes, whole=sh.whole_bytes,
                    chunk=sh.chunk_bytes, image=sh.image_bytes,
                    device_tensors=[t.device.type for t in (
                        sh.pt.tris, sh.rows, sh.scene.geometry.tri_table)])

    def ranged(mesh, scene, n_pix, spp, width, height, lo, hi, max_depth):
        film, iters = _run_wavefront(scene, n_pix, spp, 0, width, height, 0,
                                     max_depth, n_lanes=min(n_pix, 64),
                                     work_lo=lo, work_hi=hi)
        return film, iters

    def dryrun(mesh):
        pm.dryrun(mesh.size, device="cpu")
        return True

    return dict(
        render_sharded=lambda mesh, scene, *a, **k: pm.render_sharded(
            scene, *a, mesh=mesh, **k),
        render_wavefront_sharded=lambda mesh, scene, *a, **k:
            pm.render_wavefront_sharded(scene, *a, mesh=mesh, **k),
        render_bpt_sharded=lambda mesh, scene, *a, **k:
            pm.render_bpt_sharded(scene, *a, mesh=mesh, **k),
        render_pt_scene_sharded=lambda mesh, scene, *a, **k:
            ss.render_pt_scene_sharded(scene, mesh, *a, **k),
        cast=cast, occluded=occluded, shard=shard, ranged=ranged,
        dryrun=dryrun)


def main(job_path: str, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    from slr_tpu_torch.parallel.distributed import init_distributed, shutdown
    from slr_tpu_torch.parallel.mesh import make_mesh

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    assert init_distributed(device="cpu", init_method=job["init"])
    mesh = make_mesh("cpu")
    table = _jobs()
    results = [_numpy(table[name](mesh, *args, **kw))
               for name, args, kw in job["jobs"]]
    with open(os.path.join(out_dir, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(dict(rank=mesh.rank, size=mesh.size, results=results), f)
    shutdown()


def run_ranks(n: int, jobs: list, tmp_dir: str, timeout: float = 240.0
              ) -> list:
    """Run `jobs` ([(name, args, kwargs)], scenes as the port's CPU scenes)
    on a gloo world of `n` worker processes; returns each rank's result
    list, rank by rank. A failing rank fails the call with its output."""
    os.makedirs(tmp_dir, exist_ok=True)
    job_path = os.path.join(tmp_dir, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(dict(init="file://" + os.path.join(tmp_dir, "store"),
                         jobs=jobs), f)
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job_path, tmp_dir],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    results = []
    for rank in range(n):
        with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "rb") as f:
            res = pickle.load(f)
        assert res["rank"] == rank and res["size"] == n
        results.append(res["results"])
    return results


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
