"""The harness finds a cell's files and a metric's reader by name alone."""

import json
import re

import pytest

from benchmark.harness import runner, spec, stats
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    manifest_path, bench = tiny.layout(tmp_path)
    before = {p: p.read_text() for p in bench.rglob("*") if p.is_file()}
    # A later change adds only files and manifest entries.
    tiny.write(bench / "traffic" / "sift-tiny.single.json", dict(tiny.SIFT_TRAFFIC, queries_per_call=1))
    tiny.write(bench / "workloads" / "sift-tiny.single.json", {"limits": {"dist_rel_err": 1e-3}})
    (bench / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    manifest = json.loads(manifest_path.read_text())
    manifest["workloads"].append({"name": "sift-tiny.single", "config": "sift-tiny.batch",
                                  "traffic": "sift-tiny.single", "chips": 1, "why": "tests"})
    manifest["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                                  "source": "host_clock", "layer": "query entry", "moves": "qps",
                                  "workloads": ["sift-tiny.single"]})
    tiny.write(manifest_path, manifest)
    cell = spec.find_cell("sift-tiny.single", manifest_path, bench)
    assert cell.traffic["queries_per_call"] == 1
    assert cell.limits == {"dist_rel_err": 1e-3}
    assert "calls_in_window" in [m["name"] for m in cell.per_layer]
    assert spec.find_cell("sift-tiny.batch", manifest_path, bench).per_layer[-1]["name"] != \
        "calls_in_window"
    assert spec.load_driver(cell).Driver.__name__ == "Driver"
    run = runner.Run(setup_s=1.0, build_s=1.0, build_rows=1,
                     calls=[stats.CallRecord(0.0, 1.0, 1)] * 3, window_s=3.0, recall=1.0,
                     spans={}, info={}, trace=None)
    assert spec.load_reader("calls_in_window", bench).read(run) == 3
    for p, text in before.items():
        assert p.read_text() == text


def test_unknown_cell_is_refused(tmp_path):
    manifest_path, bench = tiny.layout(tmp_path)
    with pytest.raises(KeyError):
        spec.find_cell("no-such.cell", manifest_path, bench)


@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_manifest()["workloads"]])
def test_every_cell_resolves(cell):
    c = spec.find_cell(cell)
    assert (spec.BENCH_DIR / "drivers" / f"{c.config['driver']}.py").is_file()
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.load_reader(m["name"]).read)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:  # each per-layer metric moves a metric its cell reports
        assert m["moves"] in e2e
    assert c.limits and all(v > 0 for v in c.limits.values())


def test_manifest_keeps_to_the_contract():
    m = spec.load_manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [x["name"] for x in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (spec.ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert m["run_seconds"] == int(m["run_seconds"]) and 1 <= m["run_seconds"] <= 51
    texts = [x[k] for x in m["configs"] + m["workloads"] + m["per_layer"]
             for k in ("why", "source", "layer") if k in x] + m["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert len(spec.MANIFEST.read_bytes()) <= 64 * 1024
