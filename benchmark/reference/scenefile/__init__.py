"""The SLR scene-file reader: `read_scene(path)` parses and executes a scene
file into the scene graph of `graph.py`."""
