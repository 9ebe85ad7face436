"""Gradient steps of scene-parameter fitting: `render/pt.py` `render` (the
fixed-depth tracer) forward, a mean squared error against a target image
made from the seed, `backward()`, then one Adam step on the leaves. The
leaves are spectral reflectance curves sampled every nanometre, of the
spectrum textures `curve_rows`, and the scales of the tabulated spectra
`scale_rows`; spectrum textures are numbered in the order a depth-first
walk of the scene graph first meets them, as the program's table holds
them. The sample offset advances by step.

Set-up builds the one step object (scene, leaves, optimizer) and drives it
through its first `checked_steps` steps, which also warm it up; the window
continues with the same object. The reference (`reference/pathtracer.py`,
its own load of the scene file, its own leaves and Adam) follows those
first steps: each step's loss, the norm of the first gradient per leaf as
Adam holds it after one step, and the norm of each leaf's change after the
steps are compared.
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics

import torch

from entries import load_program_scene
from harness.clock import run_window, sync

BETAS = (0.9, 0.999)


def _params(run):
    t = run.cell.traffic
    return (int(t["width"]), int(t["height"]), int(t["spp"]),
            int(t["max_depth"]))


def target_image(run, h: int, w: int) -> torch.Tensor:
    """A smooth random image from the seed: 16 x 16 blocks of uniform
    values in [0.1, 1.1], bilinearly upsampled."""
    g = run.generator(salt=3)
    coarse = 0.1 + torch.rand((1, 3, max(h // 16, 1), max(w // 16, 1)),
                              generator=g, device=run.device)
    img = torch.nn.functional.interpolate(coarse, size=(h, w),
                                          mode="bilinear",
                                          align_corners=False)
    return img[0].permute(1, 2, 0).contiguous()


def make_leaves(scene, traffic):
    """Initial leaf values from the program's scene tables: one curve per
    `curve_rows` row, one scale per `scale_rows` row."""
    stex = scene.stex
    rows = torch.tensor(traffic["curve_rows"], device=stex.value.device)
    cids = stex.curve_id.to(torch.int64)[rows]
    curves = [stex.curves_v[c].detach().clone() for c in cids.tolist()]
    scales = [stex.value[r, 0].detach().clone()
              for r in traffic["scale_rows"]]
    return cids, curves + scales


def with_leaves(scene, cids, traffic, leaves):
    """The program's scene with its curves and scales replaced by the
    leaves, differentiable in them."""
    stex = scene.stex
    n_c = len(traffic["curve_rows"])
    curves_v = stex.curves_v.index_copy(0, cids, torch.stack(leaves[:n_c]))
    srows = torch.tensor(traffic["scale_rows"], device=stex.value.device)
    col = torch.zeros_like(srows)
    value = stex.value.index_put((srows, col), torch.stack(leaves[n_c:]))
    return dataclasses.replace(scene, stex=dataclasses.replace(
        stex, curves_v=curves_v, value=value))


class Fit:
    """The step object: leaves, Adam, a target, and `render(leaves, k)`,
    the image of sample k as a function of the leaves."""

    def __init__(self, run, init, render):
        self.run, self.render = run, render
        self.init = init
        self.leaves = [x.clone().requires_grad_(True) for x in init]
        self.opt = torch.optim.Adam(self.leaves,
                                    lr=float(run.cell.traffic["lr"]),
                                    betas=BETAS)
        w, h, _, _ = _params(run)
        self.target = target_image(run, h, w)

    def step(self, k: int, span=None) -> torch.Tensor:
        span = span or (lambda name: contextlib.nullcontext())
        self.opt.zero_grad(set_to_none=True)
        with span("forward"):
            img = self.render(self.leaves, k)
            loss = ((img - self.target.to(img.dtype)) ** 2).mean()
        with span("backward"):
            loss.backward()
        self.opt.step()
        return loss.detach()

    def first_steps(self, n: int) -> dict:
        """Steps 0..n-1 with the numbers the comparison reads."""
        losses, grads = [], None
        for k in range(n):
            losses.append(float(self.step(k)))
            if k == 0:
                # The gradient Adam got: its first moment after one step,
                # over (1 - beta1); a step that did not run left none.
                grads = [float(self.opt.state[p]["exp_avg"].norm()
                               / (1.0 - BETAS[0]))
                         if "exp_avg" in self.opt.state[p] else 0.0
                         for p in self.leaves]
        changes = [float((p.detach() - p0).norm())
                   for p, p0 in zip(self.leaves, self.init)]
        return {"loss": losses, "grad": grads, "change": changes}


def program_fit(run, scene) -> Fit:
    """The step object of the program: `render/pt.py` `render`."""
    from slr_tpu_torch.render import pt as ppt

    tr = run.cell.traffic
    w, h, spp, depth = _params(run)
    cids, init = make_leaves(scene, tr)

    def render(leaves, k):
        return ppt.render(with_leaves(scene, cids, tr, leaves), w, h,
                          spp=spp, seed=run.seed32, max_depth=depth,
                          sample_offset=k, device=run.device)
    return Fit(run, init, render)


def reference_fit(run, lowp: bool = False) -> Fit:
    """The same fit in the reference (in bfloat16 paths when `lowp`)."""
    from reference import pathtracer as rpt

    from harness.casts import reference_scene

    tr = run.cell.traffic
    w, h, spp, depth = _params(run)
    ref = reference_scene(run)
    rows, scales = tr["curve_rows"], tr["scale_rows"]

    def render(leaves, k):
        return rpt.render_image(ref, w, h, spp, run.seed32, depth, k,
                                rpt.override(ref, rows, scales, leaves),
                                lowp)
    return Fit(run, rpt.leaves(ref, rows, scales), render)


def setup(run) -> None:
    scene = load_program_scene(run)
    fit = program_fit(run, scene)
    run.state["fit"] = fit
    run.state["scene"] = scene
    run.kept["program"] = fit.first_steps(int(run.cell.traffic[
        "checked_steps"]))
    run.state["next_step"] = int(run.cell.traffic["checked_steps"])
    sync(run.device)


def window(run, seconds: float) -> tuple[dict, int]:
    fit, k0 = run.state["fit"], run.state["next_step"]
    n, elapsed = run_window(lambda i: fit.step(k0 + i), seconds,
                             run.device, run.spans.setdefault("call", []))
    return {"grad_step_ms": elapsed * 1e3 / n}, n


def traced(run) -> None:
    from harness.trace import DeviceTrace

    fit, k0 = run.state["fit"], run.state["next_step"]
    with DeviceTrace() as tr:
        with run.span("window"):
            for i in range(int(run.cell.traffic["traced_steps"])):
                with run.span("step"):
                    fit.step(k0 + i, run.span)
    run.events = tr.events


def release(run) -> None:
    run.state.clear()


def check(run) -> dict:
    return compare(run.kept["program"], reference_fit(run).first_steps(
        int(run.cell.traffic["checked_steps"])))


def calibrate(run, loss_rows: int = 1) -> dict:
    """The program's first steps from a fresh step object, compared;
    `loss_rows` = 2 plants the fault of half the batch left out (the loss
    is the mean over every second image row)."""
    fit = program_fit(run, run.state["scene"])
    if loss_rows != 1:
        render = fit.render
        fit.target = fit.target[::loss_rows]
        fit.render = lambda leaves, k: render(leaves, k)[::loss_rows]
    run.kept["program"] = fit.first_steps(
        int(run.cell.traffic["checked_steps"]))
    del fit
    return check(run)


def control(run) -> dict:
    """The reference in bfloat16 in the program's place."""
    n = int(run.cell.traffic["checked_steps"])
    return compare(reference_fit(run, lowp=True).first_steps(n),
                   reference_fit(run).first_steps(n))


def _leaf_gaps(got, want, skip=()):
    floor = statistics.median(want)
    return max((abs(g - w) / max(w, floor) for i, (g, w)
                in enumerate(zip(got, want)) if i not in skip), default=0.0)


def compare(prog: dict, ref: dict) -> dict:
    """loss_gap: the largest relative gap of a step's loss; grad_gap and
    change_gap: by the worst leaf, the gap between the program's norm and
    the reference's over the larger of the reference's norm of that leaf
    and of the median leaf. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                       ref["loss"]))
    g_floor = statistics.median(ref["grad"])
    still = {i for i, g in enumerate(ref["grad"]) if g < 1e-3 * g_floor}
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gaps(prog["grad"], ref["grad"]),
            "change_gap": _leaf_gaps(prog["change"], ref["change"], still)}
