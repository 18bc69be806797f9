"""recall_at_10.single: recall_at_10's reading, in the cells that send one
query a call; their few hundred queries a window spread more from seed to
seed, so the metric has a bound of its own."""

import pathlib

from benchmark.harness import spec

read = spec.load_reader("recall_at_10", pathlib.Path(__file__).resolve().parent.parent).read
