"""Seconds of the program's `load_scene` in set-up (scene file to flat
scene on the device: the DSL, the SBVH build, the tables)."""


def read(run):
    return run.counters.get("scene.load_s")
