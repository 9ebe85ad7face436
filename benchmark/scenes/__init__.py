"""The configurations' scenes, frozen: scene files kept in this folder."""
from __future__ import annotations

import os

HERE = os.path.dirname(os.path.abspath(__file__))


def scene_path(config: dict) -> str:
    """The scene file of a configuration (`"scene": {"file": name}`)."""
    return os.path.join(HERE, config["scene"]["file"])
