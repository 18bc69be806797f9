"""The port's benchmark: one run of one cell on the machine it starts on.

    python3 benchmark/run.py --workload sift1m.batch --seed 7 --seconds 30 --trace 0

`--workload` names a cell of BENCHMARK.json. The run makes its inputs and
weights from `--seed`, builds the index, warms the cell's own shapes, then
measures for `--seconds` with one closed-loop client. With `--trace 1` it
also profiles a steady slice of the window and reports the cell's
per-layer metrics instead of its end-to-end ones. After the window the
plain reference judges every answer. Set-up parts, then each number
compared beside its limit, go to standard error; the last line of standard
output is the result as one JSON object. Without enough CUDA devices, or
with JAX or the JAX package loaded, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "islands_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (the port's name only begins with the latter's)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Build and kernel caches at fixed paths inside the checkout; no library
    # may bring in JAX by itself.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import runner, spec

    # The program under test is this checkout's port, never an installed copy.
    import islands_tpu_torch

    if ROOT not in pathlib.Path(islands_tpu_torch.__file__).resolve().parents:
        runner.log(f"the port under test is not this checkout's: {islands_tpu_torch.__file__}")
        return 4
    torch.set_num_threads(4)
    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        runner.log(f"{args.workload} needs {cell.chips} CUDA device(s); "
                   f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    runner.log(f"card: {card_line()}")
    out = runner.run_cell(cell, args.seed & (2**63 - 1), args.seconds, bool(args.trace), "cuda",
                          T_START)
    found = forbidden_modules()
    if found:
        runner.log(f"JAX or the JAX package was loaded: {', '.join(found)}")
        return 3
    for line in runner.format_checks(out["checks"]):
        runner.log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
