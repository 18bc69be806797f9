"""device_idle_pct.single: device_idle_pct.batch's reading, in the cells
that send one query a call (their end-to-end metric is query_p95_ms)."""

import pathlib

from benchmark.harness import spec

read = spec.load_reader("device_idle_pct.batch", pathlib.Path(__file__).resolve().parent.parent).read
