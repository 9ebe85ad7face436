"""The share of the casts' device time that `prepare_cast` takes in the
traced pass (ranges, exit clamp, packed rays, worklists): 100 x the device
milliseconds of the program's `cast.prepare` spans over those of its
`cast.closest` and `cast.shadow` spans, which hold them."""
from harness.program_spans import device_ms


def read(run):
    prepare = device_ms(run, ("cast.prepare",))
    casts = device_ms(run, ("cast.closest", "cast.shadow"))
    if prepare is None or not casts:
        return None
    return 100.0 * prepare / casts
