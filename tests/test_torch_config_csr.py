"""Config, CSR graph, device rule and import isolation of the PyTorch port,
against the JAX package. Tolerance: exact (field names, defaults, arrays)."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from islands_tpu.core import config as jcfg
from islands_tpu.core.csr import CsrGraph as JCsrGraph
from islands_tpu_torch.core import config as tcfg
from islands_tpu_torch.core.csr import CsrGraph

REPO = pathlib.Path(__file__).resolve().parent.parent


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_leann_config_fields_and_defaults_match():
    assert _fields(tcfg.LeannConfig) == _fields(jcfg.LeannConfig)
    assert [m.value for m in tcfg.DistanceMetric] == [m.value for m in jcfg.DistanceMetric]
    assert [s.value for s in tcfg.PruningStrategy] == [s.value for s in jcfg.PruningStrategy]


@pytest.mark.parametrize("preset", ["paper_default", "fast", "accurate"])
def test_presets_match(preset):
    t = dataclasses.asdict(getattr(tcfg.LeannConfig, preset)())
    j = dataclasses.asdict(getattr(jcfg.LeannConfig, preset)())
    assert t == j


@pytest.mark.parametrize("bad", [
    dict(m=0), dict(m=8, m0=4), dict(m=8, ef_construction=4),
    dict(prune_ratio=1.5), dict(beam_width=0), dict(hub_percentile=-0.1),
    dict(promote_width=0), dict(max_search_iters=0), dict(refine_passes=-1),
    dict(wave_size=0), dict(expand_width=0),
])
def test_validate_rejects_what_the_reference_rejects(bad):
    with pytest.raises(jcfg.ConfigError) as jerr:
        jcfg.LeannConfig(**bad).validate()
    with pytest.raises(tcfg.ConfigError) as terr:
        tcfg.LeannConfig(**bad).validate()
    assert str(terr.value) == str(jerr.value)
    tcfg.LeannConfig().validate()


def _adjacency(rng, n, md):
    return [rng.choice([j for j in range(n) if j != i],
                       size=rng.integers(0, md + 1), replace=False).tolist()
            for i in range(n)]


def test_csr_from_adjacency_matches_reference():
    rng = np.random.default_rng(0)
    adj = _adjacency(rng, 40, 6)
    levels = rng.integers(0, 3, 40)
    t = CsrGraph.from_adjacency(adj, levels=levels, device="cpu")
    j = JCsrGraph.from_adjacency(adj, levels=levels)
    np.testing.assert_array_equal(t.neighbors.numpy(), np.asarray(j.neighbors))
    np.testing.assert_array_equal(t.degrees.numpy(), np.asarray(j.degrees))
    np.testing.assert_array_equal(t.levels.numpy(), np.asarray(j.levels))
    assert (t.entry_point, t.max_level) == (int(j.entry_point), int(j.max_level))
    assert t.storage_bytes() == j.storage_bytes()
    t.validate()
    for i in (0, 7, 39):
        np.testing.assert_array_equal(t.get_neighbors(i), j.get_neighbors(i))


def test_csr_round_trip_is_identical():
    rng = np.random.default_rng(1)
    g = CsrGraph.from_adjacency(_adjacency(rng, 50, 8), levels=rng.integers(0, 4, 50),
                                max_degree=8, device="cpu")
    offsets, flat, levels = g.to_csr_arrays()
    jo, jf, jl = JCsrGraph.from_adjacency(
        [g.get_neighbors(i).tolist() for i in range(50)], levels=levels,
        max_degree=8).to_csr_arrays()
    np.testing.assert_array_equal(offsets, jo)
    np.testing.assert_array_equal(flat, jf)
    np.testing.assert_array_equal(levels, jl)
    back = CsrGraph.from_csr_arrays(offsets, flat, levels, g.entry_point, g.max_level,
                                    max_degree=8, device="cpu")
    assert torch.equal(back.neighbors, g.neighbors)
    assert torch.equal(back.degrees, g.degrees)
    assert torch.equal(back.levels, g.levels)
    assert (back.entry_point, back.max_level) == (g.entry_point, g.max_level)


@pytest.mark.parametrize("fault", ["out_of_range", "beyond_degree", "self_loop"])
def test_csr_validate_rejects_what_the_reference_rejects(fault):
    nbrs = np.array([[1, 2, -1], [0, -1, -1], [0, 1, -1]], np.int32)
    degs = np.array([2, 1, 2], np.int32)
    if fault == "out_of_range":
        nbrs[0, 1] = 5
    elif fault == "beyond_degree":
        nbrs[1, 2] = 2
    else:
        nbrs[2, 1] = 2
    levels = np.zeros(3, np.int32)
    t = CsrGraph(torch.from_numpy(nbrs), torch.from_numpy(degs),
                 torch.from_numpy(levels), 0, 0)
    j = JCsrGraph(nbrs, degs, levels, np.int32(0), np.int32(0))
    with pytest.raises(ValueError) as jerr:
        j.validate()
    with pytest.raises(ValueError) as terr:
        t.validate()
    assert str(terr.value) == str(jerr.value)


def test_empty_graph():
    g = CsrGraph.empty(0, 4, device="cpu")
    assert g.num_nodes == 0 and g.max_degree == 4 and g.entry_point == -1
    g.validate()


def test_entry_points_default_to_cuda_and_never_fall_back():
    from islands_tpu_torch.core.build import build_index_with_sketch
    from islands_tpu_torch.core.search import StoredSearcher
    from islands_tpu_torch.device import resolve_device

    x = np.zeros((4, 8), np.float32)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_index_with_sketch(x)
    g = CsrGraph.from_adjacency([[1], [0], [0], [0]], device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StoredSearcher(g, x)
    assert resolve_device("cpu").type == "cpu"


def _port_modules():
    root = REPO / "islands_tpu_torch"
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in root.rglob("*.py"))


@pytest.mark.parametrize("module", [
    "islands_tpu_torch.core.embedding", "islands_tpu_torch.core.pq",
    "islands_tpu_torch.core.leann", "islands_tpu_torch.ops.adc",
    "islands_tpu_torch.convert"])
def test_guard_covers_the_config4_modules(module):
    # The config-4 slice's modules are among those the two guards below
    # import and parse.
    assert module in _port_modules()


def test_import_isolation_subprocess():
    """Importing every module of the port loads neither jax nor islands_tpu."""
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'islands_tpu'))\n"
            "assert not bad, bad\n"
            "print('isolated')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for p in (REPO / "islands_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "islands_tpu"), (path, name)
