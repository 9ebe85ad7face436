"""Passes of `render_wavefront`, as the CLI's `render_pass` makes them: the
traffic's frame, `pass_spp` samples a pass, the sample offset advancing by
pass from 0, the scene file's own `rngSeed` as the renderer's seed, the
configuration's depth cap, and the traffic's `lanes` (`render_wavefront`'s
`n_lanes`: the paths in flight at once) in the warm-up and every pass.

Every --seed renders the same passes: a pass's iterations (the tail of its
longest paths) depend on its random streams, and a seed that chose them
would change the work from run to run. --seed draws what the comparison
checks: `check_items` (pass, pixel) pairs, whose samples the reference
(`reference/pathtracer.py`, its own load of the scene file, in float64
with brute-force casts) traces again; the pixels' RGB are compared.

A traced run renders the window's first pass twice: untimed by the
profiler, for `wavefront.iter_ms`, then under it.
"""
from __future__ import annotations

import torch

from entries import load_program_scene
from harness.clock import run_window, sync

RTOL = 1e-3
ATOL = 1e-6


def _frame(run):
    return (int(run.cell.param("width")), int(run.cell.param("height")),
            int(run.cell.param("pass_spp")), int(run.cell.param("max_depth")))


def _pass(run, offset: int, width=None, height=None, spp=None, depth=None):
    from slr_tpu_torch.render.wavefront import render_wavefront

    w, h, s, dep = _frame(run)
    return render_wavefront(
        run.state["scene"], width or w, height or h, spp=spp or s,
        seed=run.kept["render_seed"], max_depth=depth or dep,
        sample_offset=offset, return_iters=True,
        n_lanes=int(run.cell.param("lanes")), device=run.device)


def setup(run) -> None:
    run.state["scene"] = load_program_scene(run)
    # Warm-up: the window's lanes (most of them idle past the small frame's
    # work) through a few iterations, so that kernels are loaded, buffers
    # of the window's sizes allocated and nothing is built inside the
    # window.
    warm = run.cell.traffic["warmup"]
    _pass(run, 0, warm["width"], warm["height"], 1, warm["max_depth"])
    sync(run.device)


def _keep(run, offset, img) -> None:
    run.kept.setdefault("images", []).append(img)
    run.kept.setdefault("offsets", []).append(offset)


def window(run, seconds: float) -> tuple[dict, int]:
    w, h, s, _ = _frame(run)
    iters = []

    def step(i):
        img, n = _pass(run, i * s)
        _keep(run, i * s, img)
        iters.append(n)

    n, elapsed = run_window(step, seconds, run.device,
                             run.spans.setdefault("call", []))
    run.counters["iterations"] = iters
    return {"ksamples_per_s": w * h * s * n / elapsed / 1e3}, n


def traced(run) -> None:
    from harness.trace import DeviceTrace

    w, h, s, _ = _frame(run)
    with run.span("pass_untraced"):
        _, n = _pass(run, 0)
    run.counters["iterations_untraced"] = n
    with DeviceTrace() as tr:
        with run.span("window"):
            with run.span("pass"):
                img, n = _pass(run, 0)
    _keep(run, 0, img)
    run.events = tr.events
    run.counters.update(iterations=[n], samples=w * h * s)


def release(run) -> None:
    run.state.pop("scene", None)


def _items(run):
    """`check_items` (pass, pixel) pairs drawn from the seed: the program's
    RGB there, and the (pixel, sample) items that made them."""
    w, h, s, _ = _frame(run)
    images = torch.stack(run.kept["images"])             # (P, H, W, 3)
    offsets = torch.tensor(run.kept["offsets"], device=run.device)
    k = int(run.cell.param("check_items"))
    g = run.generator(salt=11)
    which = torch.randint(0, images.shape[0], (k,), generator=g,
                          device=run.device)
    pix = torch.randint(0, w * h, (k,), generator=g, device=run.device)
    got = images[which, pix // w, pix % w]
    pid = pix.repeat_interleave(s)
    sid = (offsets[which][:, None] + torch.arange(s, device=run.device)
           ).reshape(-1)
    return got, pid, sid


def _reference(run, pid, sid, lowp=False):
    """The reference's RGB of each pixel: the mean of its items'."""
    from reference.pathtracer import trace

    from harness.casts import reference_scene

    w, h, s, depth = _frame(run)
    want = trace(reference_scene(run), pid, sid, run.kept["render_seed"],
                 w, h, depth, lowp=lowp)
    return want.reshape(-1, s, 3).mean(1)


def check(run) -> dict:
    got, pid, sid = _items(run)
    return compare(got.double(), _reference(run, pid, sid))


def calibrate(run) -> dict:
    """The window's first pass, compared at the pixels this seed draws.
    Every seed renders the same pass, so runs that share `run.cache`
    render it once."""
    if "pass0" not in run.cache:
        run.cache["pass0"] = _pass(run, 0)[0]
    run.kept.update(images=[run.cache["pass0"]], offsets=[0])
    return check(run)


def control(run) -> dict:
    """The reference in bfloat16 in the program's place."""
    if "images" not in run.kept:
        w, h, _, _ = _frame(run)
        run.kept.update(images=[torch.zeros((h, w, 3), device=run.device)],
                        offsets=[0])
    _, pid, sid = _items(run)
    return compare(_reference(run, pid, sid, lowp=True),
                   _reference(run, pid, sid))


def compare(got, want) -> dict:
    """The share of pixels where some channel differs by more than rtol
    1e-3 of the pixel's largest channel (+ atol 1e-6). Channels are
    measured against the pixel's largest because linear sRGB channels of
    a spectral sample can cancel to nearly nothing."""
    scale = want.abs().amax(-1)
    far = (got - want).abs().amax(-1) > RTOL * scale + ATOL
    return {"far_share": float(far.float().mean())}
