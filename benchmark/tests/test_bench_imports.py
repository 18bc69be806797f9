"""What the benchmark loads, and how it stops without a card."""

import ast
import os
import subprocess
import sys

from benchmark.harness import spec

CHECK = r"""
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1]); sys.path.insert(0, str(root))
import benchmark.run, benchmark.control
from benchmark.harness import spec
bench = root / "benchmark"
for sub in ("harness", "reference"):
    for p in sorted((bench / sub).glob("*.py")):
        importlib.import_module(f"benchmark.{sub}.{p.stem}")
for p in sorted((bench / "drivers").glob("*.py")):
    spec._load_file(p, "benchmark_driver_")
for p in sorted((bench / "metrics").glob("*.py")):
    spec.load_reader(p.stem, bench)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package():
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", CHECK, str(spec.ROOT)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "islands_tpu_torch" in top and "benchmark" in top
    assert not top & {"jax", "jaxlib", "flax", "islands_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    for p in (spec.BENCH_DIR / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "math", "__future__", "benchmark"), (p, n)
                assert not n.startswith(("benchmark.drivers", "benchmark.harness")), (p, n)


def test_no_card_means_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
                          "sift1m.batch", "--seed", "0", "--seconds", "10", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_without_the_port_the_run_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's folder."""
    import shutil

    shutil.copy(spec.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(tmp_path / "benchmark" / "run.py"),
                          "--workload", "sift1m.batch", "--seed", "0", "--seconds", "10",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         env=env, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
