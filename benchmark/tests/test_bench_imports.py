"""Nothing the benchmark runs loads JAX or the JAX package: a fresh process
imports every module of the harness, and a scan of its sources finds no
import of them, by whole top-level module name (the port's name begins
with the JAX package's). The reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "ptts_tpu"}


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "ptts_torch" not in set(_imports(path)), path


def test_fresh_process_loads_no_jax():
    mods = ["benchmark.run", "benchmark.check", "benchmark.system", "benchmark.serving",
            "benchmark.sweep", "benchmark.control", "benchmark.traffic.open_loop_serve",
            "benchmark.traffic.closed_loop_serve", "benchmark.traffic.offline_batch",
            "ptts_torch.runtime.batching", "ptts_torch.runtime.engine"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN
    assert "ptts_torch" in loaded
