"""Window drivers, one per entry point of the program. Each module has
`setup(run)`, `window(run, seconds) -> (end-to-end values, attempted)`,
`traced(run)`, `release(run)` and `check(run) -> numbers compared`, and for
`calibrate.py` `calibrate(run)` and `control(run)`."""
from __future__ import annotations

import time

from harness.clock import sync
from scenes import scene_path


def load_program_scene(run):
    """The cell's scene file through the program's `load_scene` onto the
    run's device; its seconds are the per-layer `scene.load_s`. The scene
    file's own `rngSeed` (as the CLI takes it) is kept as `render_seed`."""
    from slr_tpu_torch.scene.api import load_scene

    path = scene_path(run.cell.config)
    run.kept["scene_path"] = path
    sync(run.device)
    t0 = time.perf_counter()
    scene, _, settings = load_scene(
        path, spectral=run.cell.config["spectral"], device=run.device)
    sync(run.device)
    run.counters["scene.load_s"] = time.perf_counter() - t0
    run.kept["render_seed"] = int(settings.get("rngSeed", 0)) & 0xFFFFFFFF
    return scene
