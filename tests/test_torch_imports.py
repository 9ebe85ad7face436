"""The port stands alone: nothing under slr_tpu_torch/, nor chip_smoke.py or
tools/torch_*.py, imports JAX, the slr_tpu package or PIL (the machine with
the card has neither JAX nor PIL; the port decodes PNGs itself). Checked
twice: every module is imported in a process where any import of `jax`,
`jaxlib`, `slr_tpu` or `PIL` raises, and every import statement of those
files, function bodies included, is read from the source."""
import ast
import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "slr_tpu", "PIL")


def _port_files() -> list[str]:
    files = glob.glob(os.path.join(ROOT, "slr_tpu_torch", "**", "*.py"),
                      recursive=True)
    files += [os.path.join(ROOT, "chip_smoke.py")]
    files += glob.glob(os.path.join(ROOT, "tools", "torch_*.py"))
    return sorted(files)


_GUARDED_IMPORTS = r"""
import glob, importlib, importlib.abc, importlib.util, os, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Refuse())
import slr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(slr_tpu_torch.__path__,
                                               "slr_tpu_torch.")]
assert {{"slr_tpu_torch.render.bpt", "slr_tpu_torch.render.ppm",
         "slr_tpu_torch.parallel.distributed", "slr_tpu_torch.parallel.mesh",
         "slr_tpu_torch.parallel.scene_shard", "slr_tpu_torch.accel.plucker",
         "slr_tpu_torch.accel.twolevel"}} <= set(names)
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
tools = sorted(glob.glob(os.path.join("tools", "torch_*.py")))
for path in tools:
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m.split(".")[0] in {forbidden!r}]
assert not bad, bad
print(len(names), len(tools))
"""


def test_port_modules_import_without_jax_or_slr_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _GUARDED_IMPORTS.format(forbidden=FORBIDDEN)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_modules, n_tools = map(int, proc.stdout.split())
    assert n_modules >= 30 and n_tools >= 2


def test_no_import_statement_names_jax_or_slr_tpu():
    """Lazy imports inside functions included."""
    found = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(os.path.relpath(path, ROOT), n) for n in names
                      if n.split(".")[0] in FORBIDDEN]
    assert not found, found
    assert len(_port_files()) >= 35


def test_sharded_paths_and_oracles_are_read():
    """The modules of rendering across ranks and the oracles are among the
    files whose imports are read, and the CPU ranks' worker and the test
    helpers they load import no JAX either."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in ("distributed", "mesh", "scene_shard"):
        assert os.path.join("slr_tpu_torch", "parallel", name + ".py") in files
    for name in ("plucker", "twolevel", "instances", "lbvh"):
        assert os.path.join("slr_tpu_torch", "accel", name + ".py") in files
    for helper in ("torch_dist_worker.py", "torch_shard_scenes.py"):
        with open(os.path.join(ROOT, "tests", helper)) as f:
            tree = ast.parse(f.read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module or "" for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [m for m in mods if m.split(".")[0] in FORBIDDEN], helper
