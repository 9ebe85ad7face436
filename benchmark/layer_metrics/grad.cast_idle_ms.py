"""Milliseconds of device idle a traced gradient step whose gap starts on
the host under one of the program's cast spans (`cast.closest`,
`cast.shadow`, `cast.prepare`): the host preparing or launching a cast
while the device waits."""
from harness.program_spans import idle_ms_per_step


def read(run):
    return idle_ms_per_step(run, lambda name: name.startswith("cast."))
