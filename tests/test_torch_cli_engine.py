"""The port's engine commands (`build`, `query`, `eval`) against the
reference CLI's, on the same small vector files.

Each package's CLI builds an index file, with and without `--pq`; both
CLIs then query each file (the file format is the reference's, byte for
byte) and must return the same ids, with distances within 1e-5 (the
tolerance of tests/test_torch_leann.py's parity checks), and `eval` must
report the same recall. The port runs with `--device cpu`."""

import json

import numpy as np
import pytest

from islands_tpu import cli as j_cli
from islands_tpu_torch import cli

N, D, B, M = 512, 32, 24, 8


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded Gaussian vectors and queries, and four index files: the
    reference's and the port's build, each with and without PQ."""
    tmp = tmp_path_factory.mktemp("engine")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    paths = {"x": str(tmp / "x.npy"), "q": str(tmp / "q.npy")}
    np.save(paths["x"], x)
    np.save(paths["q"], q)
    for who, main, extra in (("reference", j_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        for pq in (False, True):
            out = str(tmp / f"{who}{'_pq' if pq else ''}.leann")
            argv = ["build", paths["x"], "-o", out, "--m", str(M), "--metric", "euclidean"]
            if pq:
                argv += ["--pq", "--pq-subquantizers", "4"]
            assert main(argv + extra) == 0
            paths[(who, pq)] = out
    return paths


def _query(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# Query knobs: the CLI's defaults, then each flag it has.
KNOBS = {
    "defaults": [],
    "ef48": ["--ef", "48", "-k", "5"],
    "promote/iters": ["--promote-width", "6", "--max-iters", "12"],
    "end-rerank": ["--end-rerank"],
    "exact": ["--exact"],
}


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("pq", [False, True], ids=["graph", "pq"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_query_matches_the_reference_cli(files, writer, pq, knobs, capsys):
    argv = ["query", files[(writer, pq)], files["x"], files["q"]] + KNOBS[knobs]
    want = _query(j_cli.main, argv, capsys)
    got = _query(cli.main, argv + ["--device", "cpu"], capsys)
    k = 5 if "-k" in KNOBS[knobs] else 10
    assert np.asarray(got["ids"]).shape == (B, k)
    assert got["ids"] == want["ids"]
    np.testing.assert_allclose(got["distances"], want["distances"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("pq", [False, True], ids=["graph", "pq"])
def test_eval_reports_the_same_recall(files, pq, capsys):
    for writer in ("reference", "port"):
        argv = ["eval", files[(writer, pq)], files["x"], files["q"], "--ef", "48"]
        want = _query(j_cli.main, argv, capsys)
        got = _query(cli.main, argv + ["--device", "cpu"], capsys)
        assert got["recall"] == want["recall"] and got["recall"] >= 0.8
        assert {k: got[k] for k in ("ef", "k", "n")} == {k: want[k] for k in ("ef", "k", "n")}
        assert got["qps"] > 0


def test_build_prints_the_reference_line(files, tmp_path, capsys):
    out = str(tmp_path / "i.leann")
    assert cli.main(["build", files["x"], "-o", out, "--m", str(M), "--device", "cpu"]) == 0
    line = capsys.readouterr().out
    assert line.startswith(f"OK built {N} vectors in ") and line.rstrip().endswith(f"-> {out}")
    assert cli.main(["build", files["x"] + ".txt", "-o", out, "--device", "cpu"]) == 1
    assert "unsupported vector file" in capsys.readouterr().err
