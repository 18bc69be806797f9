"""The control of a cell's correctness check, on the chip.

    python3 benchmark/control.py --workload sift1m.batch --seeds 11 12 13

For each seed, makes the cell's inputs and weights as a run does and puts
the plain reference, computed one precision step below the configuration's
(TF32 for a float32 index, float8 for a bfloat16 encoder), in the
program's place, then judges its answers as a run judges the program's.
Prints one JSON line a seed with every number beside the cell's limit; a
sound limit finds every one of them not correct. The benchmark's own runs
never run this.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def control_readings(cell, seed: int, device) -> dict:
    """The control's numbers and verdict for one seed."""
    import torch

    from benchmark.harness import checks, spec, trace

    dev = torch.device(device)
    drv = spec.load_driver(cell).Driver(cell.config, cell.traffic, seed, dev,
                                        trace.Spans(False, dev))
    drv.make_inputs()
    drv.make_weights()
    numbers = drv.control()
    correct, shown = checks.verdict(numbers.pop("bad_answers"), numbers, cell.limits)
    return {"workload": cell.name, "seed": seed, "correct": correct, "checks": shown}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import spec

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(control_readings(cell, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
