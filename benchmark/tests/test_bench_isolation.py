"""What the benchmark loads and reads: no JAX, no JAX package (compared by
whole top-level names: the port's name begins with the JAX package's), a
reference that takes nothing of the port, and no run without a card or
without the program."""
import ast
import os
import shutil
import subprocess
import sys

from benchlib import harness
from conftest import BENCH, ROOT


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources(*parts):
    for dirpath, _dirs, files in os.walk(os.path.join(BENCH, *parts)):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "scroll_prover_tpu_torch_probe", sys)
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "scroll_prover_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    found = harness.forbidden_modules()
    assert "scroll_prover_tpu" in found and "jaxlib" in found
    assert "scroll_prover_tpu_torch" not in found


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("benchref"):
        for name in _imports(path):
            assert name.split(".")[0] in {"__future__", "hashlib", "numpy", "benchref"} or \
                name.startswith("."), (path, name)


def test_no_file_of_the_jax_benchmark_is_read():
    for path in (p for p in _sources() if os.sep + "tests" + os.sep not in p):
        with open(path) as fh:
            text = fh.read()
        for name in ("bench.py", "BENCH_r", "MULTICHIP_r", "BASELINE.json"):
            assert name not in text, (path, name)


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "chunk18.fresh_traces", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _run(ROOT, env)
    assert res.returncode != 0 and not res.stdout.strip()


def test_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    res = _run(tmp_path, env)
    assert res.returncode != 0 and not res.stdout.strip()
