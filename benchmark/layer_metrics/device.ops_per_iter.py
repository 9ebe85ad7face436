"""Device operations (kernels, copies, sets) in the traced pass per
wavefront iteration: the host's launch load."""


def read(run):
    iters = run.counters.get("iterations")
    if run.summary is None or not iters or not run.summary.device_ops:
        return None
    return run.summary.device_ops / iters[0]
