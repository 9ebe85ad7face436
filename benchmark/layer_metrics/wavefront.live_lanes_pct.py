"""The share of lanes live in the traced pass: 100 x the sum of the
program's `live` counts (lanes still holding work at an iteration's start,
from the loop's own test) over the sum of its `lanes` counts, over the
pass's `wavefront.iter` spans. A count, which repeats exactly."""
from harness.program_spans import records


def read(run):
    its = [r for r in records(run) or () if r.name == "wavefront.iter"]
    lanes = sum(r.counts.get("lanes", 0) for r in its)
    if not lanes:
        return None
    return 100.0 * sum(r.counts.get("live", 0) for r in its) / lanes
