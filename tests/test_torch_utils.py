"""The port's tracing and output modules against tests/test_utils.py's cases.

Every case runs islands_tpu's module and islands_tpu_torch's on the same
inputs and wants the same snapshots, log lines and strings. The reference's
persistent compilation cache is a TPU workaround the port leaves out. The
span's wait for the card is checked in tests/test_torch_cuda.py."""

import io
import json
import logging
import threading

import pytest
import torch

from islands_tpu import output as j_output
from islands_tpu.utils import tracing as j_tracing
from islands_tpu_torch import output
from islands_tpu_torch import utils
from islands_tpu_torch.utils import tracing

BOTH = [j_tracing, tracing]


def _feed(m):
    m.incr("queries")
    m.incr("queries", 4)
    m.gauge("recall", 0.95)
    m.record_timing("search", 0.5)
    m.record_timing("search", 1.5)
    m.record_timing("build", 1 / 3)
    return m.snapshot()


class TestMetrics:
    def test_counters_gauges_timings(self):
        snaps = [_feed(mod.Metrics()) for mod in BOTH]
        assert snaps[1] == snaps[0]
        snap = snaps[1]
        assert snap["counters"]["queries"] == 5
        assert snap["gauges"]["recall"] == 0.95
        assert snap["timings"]["search"]["count"] == 2
        assert snap["timings"]["search"]["mean_s"] == pytest.approx(1.0)

    @pytest.mark.parametrize("mod", BOTH, ids=["reference", "port"])
    def test_reset(self, mod):
        m = mod.Metrics()
        _feed(m)
        m.reset()
        assert m.snapshot() == {"counters": {}, "gauges": {}, "timings": {}}

    def test_thread_safety_smoke(self):
        counts = []
        for mod in BOTH:
            m = mod.Metrics()
            threads = [threading.Thread(target=lambda: [m.incr("c") for _ in range(500)])
                       for _ in range(4)]
            [t.start() for t in threads]
            [t.join() for t in threads]
            counts.append(m.snapshot()["counters"]["c"])
        assert counts == [2000, 2000]


class TestSpan:
    def test_span_records_timing(self):
        for mod in BOTH:
            mod.metrics.reset()
            with mod.span("unit-test-span"):
                pass
            assert mod.metrics.snapshot()["timings"]["unit-test-span"]["count"] == 1

    @pytest.mark.parametrize("block_on", [
        "tensor", "nest", "empty nest"])
    def test_span_on_cpu_tensors_needs_no_device_wait(self, block_on, monkeypatch):
        # A span over CPU tensors records its time and never waits on a
        # CUDA device (there is none to wait for).
        def no_sync(*a, **kw):
            raise AssertionError("span synchronised a device for CPU tensors")

        monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
        x = torch.ones((64, 64))
        tree = {"tensor": x, "nest": {"a": [x, (x, 3)], "b": None},
                "empty nest": []}[block_on]
        tracing.metrics.reset()
        with tracing.span("matmul", block_on=tree):
            x @ x
        assert tracing.metrics.snapshot()["timings"]["matmul"]["count"] == 1

    def test_span_logs_its_time(self, caplog):
        with caplog.at_level(logging.DEBUG, logger="islands_tpu_torch.trace"):
            with tracing.span("logged", block_on=torch.zeros(3)):
                pass
        assert any(r.name == "islands_tpu_torch.trace" and "logged took" in r.getMessage()
                   for r in caplog.records)

    def test_recompute_efficiency(self):
        fracs = [mod.record_recompute_efficiency(250, 1000) for mod in BOTH]
        assert fracs == [0.25, 0.25]
        assert (tracing.metrics.snapshot()["gauges"]["recompute_fraction"]
                == j_tracing.metrics.snapshot()["gauges"]["recompute_fraction"] == 0.25)
        assert (tracing.record_recompute_efficiency(3, 0)
                == j_tracing.record_recompute_efficiency(3, 0))


class TestJsonLogging:
    @pytest.mark.parametrize("exc", [False, True])
    def test_formatter_emits_the_same_json_lines(self, exc):
        info = None
        if exc:
            try:
                raise ValueError("boom")
            except ValueError:
                import sys

                info = sys.exc_info()
        rec = logging.LogRecord(
            "islands_tpu.test", logging.INFO, __file__, 1, "hello %s", ("x",), info
        )
        lines = [mod.JsonFormatter().format(rec) for mod in BOTH]
        assert lines[1] == lines[0]
        out = json.loads(lines[1])
        assert out["message"] == "hello x"
        assert out["level"] == "info"
        assert ("exception" in out) == exc

    @pytest.mark.parametrize("json_output", [True, False])
    def test_init_logging(self, json_output, monkeypatch):
        monkeypatch.delenv("ISLANDS_LOG_LEVEL", raising=False)
        saved = {n: (logging.getLogger(n).handlers[:], logging.getLogger(n).level)
                 for n in ("islands_tpu", "islands_tpu_torch")}
        try:
            j_tracing.init_logging("debug", json_output)
            tracing.init_logging("debug", json_output)
            j_root, root = logging.getLogger("islands_tpu"), logging.getLogger("islands_tpu_torch")
            assert root.level == j_root.level == logging.DEBUG
            assert len(root.handlers) == len(j_root.handlers) == 1
            assert (isinstance(root.handlers[0].formatter, tracing.JsonFormatter)
                    == isinstance(j_root.handlers[0].formatter, j_tracing.JsonFormatter)
                    == json_output)
        finally:
            for n, (handlers, level) in saved.items():
                logging.getLogger(n).handlers[:] = handlers
                logging.getLogger(n).setLevel(level)

    def test_utils_exports(self):
        assert set(utils.__all__) == {
            "JsonFormatter", "Metrics", "init_logging", "metrics",
            "record_recompute_efficiency", "span"}


class _Tty(io.StringIO):
    def isatty(self):
        return True


class TestOutput:
    @pytest.mark.parametrize("headers,rows", [
        (["a", "bb"], [["1", "2"], ["333", "4"]]),
        (["name", "repository", "chunks", "files", "bytes"],
         [["proj", "org/proj", 12, 3, 40960], ["x", "y", 0, 0, 0]]),
        (["only"], []),
    ])
    def test_table(self, headers, rows):
        t = output.table(headers, rows)
        assert t == j_output.table(headers, rows)
        if headers == ["a", "bb"]:
            lines = t.splitlines()
            assert lines[1] == "| a   | bb |"
            assert "| 333 | 4  |" in lines

    @pytest.mark.parametrize("tty", [False, True])
    def test_styles(self, tty, monkeypatch, capsys):
        monkeypatch.delenv("NO_COLOR", raising=False)
        outs = []
        for mod in (j_output, output):
            stream = _Tty() if tty else io.StringIO()
            monkeypatch.setattr("sys.stdout", stream)
            monkeypatch.setattr("sys.stderr", stream)
            mod.success("done")
            mod.warning("careful")
            mod.info("fyi")
            mod.error("bad")
            outs.append((stream.getvalue(), mod._style("x", "32;1", stream)))
        assert outs[1] == outs[0]
        assert ("\x1b[32;1mOK\x1b[0m" in outs[1][0]) == tty

    @pytest.mark.parametrize("tty", [False, True])
    def test_progress_and_spinner(self, tty, monkeypatch):
        monkeypatch.delenv("NO_COLOR", raising=False)
        outs = []
        for mod in (j_output, output):
            stream = _Tty() if tty else io.StringIO()
            bar = mod.ProgressBar(4, "indexing", stream=stream)
            for _ in range(5):
                bar.advance()
            bar.finish()
            with mod.Spinner("cloning", stream=stream):
                pass
            outs.append(stream.getvalue())
        assert outs[1] == outs[0]
        assert outs[1].endswith("cloning...\n")
