"""100 x (1 - union of device activity / the traced window's wall time)
over the traced gradient steps."""


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
