"""The port's config and CLI (repository commands) against
tests/test_cli_config.py's cases.

Config loading from the environment and from JSON and YAML files (with
PyYAML, and through the fallback parser when `import yaml` fails), `to_yaml`
and `indexer_config()` must agree with islands_tpu.config. The repository
commands run through both packages' `main` on one base path, which the
reference's CLI indexed, and must print the same JSON. Every command that
touches the engine fails without a card unless `--device cpu` is given, and
then writes nothing."""

import dataclasses
import enum
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from islands_tpu import cli as j_cli
from islands_tpu import config as j_config
from islands_tpu_torch import cli
from islands_tpu_torch import config


@pytest.fixture
def base(tmp_path, monkeypatch):
    monkeypatch.setenv("ISLANDS_BASE_PATH", str(tmp_path / "islands"))
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    return tmp_path


def make_proj(tmp_path):
    src = tmp_path / "proj"
    (src / "src").mkdir(parents=True)
    (src / "src" / "main.py").write_text(
        "def hello():\n    return 'semantic search engine'\n"
    )
    (src / "src" / "store.py").write_text(
        "def save(index, path):\n    path.write_bytes(index.to_bytes())\n"
    )
    (src / "README.md").write_text("# proj\ncode indexing\n")
    return src


def _plain(v):
    """A dataclass tree as plain values (enums by value), to compare the
    two packages' configs field by field."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _configs(fn):
    """fn(config module) for both packages, compared field by field."""
    got, want = fn(config), fn(j_config)
    assert _plain(got) == _plain(want)
    assert got.to_yaml() == want.to_yaml()
    assert _plain(got.indexer_config()) == _plain(want.indexer_config())
    return got


CONFIG_FILES = {
    "c.json": json.dumps({
        "debug": True, "chunk_size": 256,
        "leann": {"m": 24, "ef_search": 96},
        "pq": {"enabled": True, "subquantizers": 16},
    }),
    "c.yaml": "debug: true\nchunk_size: 128\nleann:\n  m: 12\n  m0: 24\n",
    "knobs.yaml": "leann:\n  promote_width: 32\n  max_search_iters: 36\n",
    "encoder.yml": ("# the service on the card\nbase_path: /tmp/x  # trailing comment\n"
                    "embedding:\n  kind: encoder\n  model: minilm-l6\n  recompute: false\n"
                    "mcp:\n  port: 9090\npq:\n  enabled: true\n"),
    "flat.yaml": "embedding_kind: encoder\nembedding_model: 'minilm-l6'\nleann_m0: 48\n",
}


class TestConfig:
    def test_from_env(self, monkeypatch):
        monkeypatch.setenv("ISLANDS_DEBUG", "true")
        monkeypatch.setenv("ISLANDS_LOG_LEVEL", "debug")
        monkeypatch.setenv("ISLANDS_STORAGE__REPOS_PATH", "/tmp/r")
        monkeypatch.setenv("ISLANDS_INDEXES_PATH", "/tmp/i")
        monkeypatch.setenv("OPENAI_API_KEY", "sk-x")
        cfg = _configs(lambda m: m.Config.from_env())
        assert cfg.debug and cfg.log_level == "debug"
        assert cfg.repos_path == "/tmp/r"
        assert cfg.openai_api_key == "sk-x"
        assert "sk-x" not in cfg.to_yaml()

    @pytest.mark.parametrize("name", sorted(CONFIG_FILES))
    @pytest.mark.parametrize("pyyaml", [True, False])
    def test_from_file(self, name, pyyaml, tmp_path, monkeypatch):
        if not pyyaml:
            monkeypatch.setitem(sys.modules, "yaml", None)  # `import yaml` fails
        f = tmp_path / name
        f.write_text(CONFIG_FILES[name])
        cfg = _configs(lambda m: m.Config.from_file(f))
        if name == "c.json":
            assert cfg.leann_m == 24 and cfg.pq_enabled and cfg.pq_subquantizers == 16
        if name == "knobs.yaml":
            lc = cfg.indexer_config().leann
            assert lc.promote_width == 32 and lc.max_search_iters == 36
        if name == "encoder.yml":
            assert (cfg.embedding_kind, cfg.embedding_model) == ("encoder", "minilm-l6")
            assert cfg.indexer_config().leann.sketch_query

    @pytest.mark.parametrize("text", ["[1, 2]", "{broken", "- a\n- b\n"])
    def test_bad_files(self, text, tmp_path):
        f = tmp_path / ("c.yaml" if text.startswith("-") else "c.json")
        f.write_text(text)
        for mod in (config, j_config):
            with pytest.raises(mod.ConfigFileError):
                mod.Config.from_file(f)

    @pytest.mark.parametrize("text", [
        "# comment\na: 1\nb: true\nc: hello\nnest:\n  x: 2.5\n  y: 'q'\n",
        "a: False\nb: -3\nc: 1e-3\nd: \"quoted\"\n  orphan: 1\n",
        "",
    ])
    def test_simple_yaml_parser(self, text):
        assert config._parse_simple_yaml(text) == j_config._parse_simple_yaml(text)

    @pytest.mark.parametrize("kw", [
        {}, dict(pq_enabled=True, leann_m=10, leann_m0=20),
        dict(embedding_kind="encoder", embedding_recompute=True, leann_ef_construction=8,
             leann_m=16),
        dict(repos_path="/r", indexes_path="/i", chunk_size=64, chunk_overlap=8),
    ])
    def test_indexer_config_mapping(self, kw):
        cfg = _configs(lambda m: m.Config(**kw))
        ic = cfg.indexer_config()
        assert ic.leann.m == cfg.leann_m and (ic.pq is not None) == cfg.pq_enabled


def _json_out(text):
    """The JSON document a command printed after any status lines."""
    starts = [i for i in (text.find("["), text.find("{")) if i >= 0]
    return json.loads(text[min(starts):])


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


class TestCliFlows:
    def test_repository_commands_print_the_same_json(self, base, capsys):
        src = make_proj(base)
        assert j_cli.main(["add", str(src)]) == 0
        capsys.readouterr()
        for argv in (["list", "--format", "json"], ["status", "--format", "json"],
                     ["search", "semantic search engine", "-k", "3", "--format", "json"],
                     ["search", "save the index", "--index", "proj", "--format", "json"]):
            rc_j, out_j, _ = _run(j_cli.main, argv, capsys)
            rc, out, _ = _run(cli.main, argv + ["--device", "cpu"], capsys)
            assert rc == rc_j == 0
            got, want = _json_out(out), _json_out(out_j)
            if argv[0] == "search":
                assert got
                if argv[1] == "semantic search engine":
                    assert any("main.py" in h["path"] for h in got)
                np.testing.assert_allclose([h.pop("score") for h in got],
                                           [h.pop("score") for h in want], atol=1e-5, rtol=0)
            assert got == want
        # The text forms too.
        for argv in (["list"], ["status"]):
            assert _run(cli.main, argv + ["--device", "cpu"], capsys) == _run(
                j_cli.main, argv, capsys)

    def test_add_remove_through_the_port(self, base, capsys):
        src = make_proj(base)
        assert cli.main(["add", str(src), "--device", "cpu"]) == 0
        assert "OK indexed proj: 3 chunks from 3 files" in capsys.readouterr().out
        # The reference's CLI reads what the port's wrote.
        rc, out, _ = _run(j_cli.main, ["list", "--format", "json"], capsys)
        assert rc == 0 and _json_out(out)[0]["name"] == "proj"
        assert cli.main(["remove", "proj", "-y", "--device", "cpu"]) == 0
        rc, out, _ = _run(cli.main, ["list", "--format", "json", "--device", "cpu"], capsys)
        assert _json_out(out) == []

    def test_workspace_flow(self, base, tmp_path, monkeypatch, capsys):
        outs = []
        for i, (main, extra) in enumerate(((j_cli.main, []), (cli.main, ["--device", "cpu"]))):
            monkeypatch.setenv("ISLANDS_BASE_PATH", str(tmp_path / f"islands{i}"))
            steps = [["workspace", "create", "ws", "--description", "d"],
                     ["workspace", "add-repo", "ws", "org/alpha"],
                     ["workspace", "list"],
                     ["workspace", "remove-repo", "ws", "org/alpha"],
                     ["workspace", "delete", "ws"], ["workspace", "list"]]
            outs.append([_run(main, argv + extra, capsys) for argv in steps])
        assert outs[1] == outs[0]
        assert "ws: 1 repos" in outs[1][2][1]

    def test_config_show_and_init(self, base, tmp_path, capsys):
        outs = []
        for i, main in enumerate((j_cli.main, cli.main)):
            path = tmp_path / f"out{i}.yaml"
            outs.append((_run(main, ["config", "show"], capsys),
                         _run(main, ["config", "init", "--path", str(path)], capsys)[0],
                         path.read_text()))
        assert outs[1][0] == outs[0][0] and outs[1][2] == outs[0][2]
        assert outs[1][1] == outs[0][1] == 0
        assert "chunk_size" in outs[1][0][1]

    def test_ask_with_mock_llm(self, base, capsys):
        src = make_proj(base)
        j_cli.main(["add", str(src)])
        capsys.readouterr()
        argv = ["ask", "what", "does", "hello", "do"]
        got = _run(cli.main, argv + ["--device", "cpu"], capsys)
        assert got == _run(j_cli.main, argv, capsys)
        assert got[0] == 0 and "mock" in got[1]

    @pytest.mark.parametrize("argv", [["remove", "ghost", "-y"], ["sync", "ghost"],
                                      ["workspace", "delete", "ghost"]])
    def test_error_path(self, base, argv, capsys):
        got = _run(cli.main, argv + ["--device", "cpu"], capsys)
        assert got == _run(j_cli.main, argv, capsys)
        assert got[0] == 1 and "ERROR" in got[2]

    def test_global_flags_before_the_subcommand(self, base, tmp_path, capsys):
        """`--config`/`--format`/`--device` count before the subcommand too.
        The reference's subparsers overwrite them with their defaults, so
        there they count only after it."""
        f = tmp_path / "c.json"
        f.write_text(json.dumps({"chunk_size": 99}))
        rc, out, _ = _run(cli.main, ["--config", str(f), "config", "show"], capsys)
        assert rc == 0 and "chunk_size: 99" in out
        rc, out, _ = _run(cli.main, ["--format", "json", "--device", "cpu", "status"], capsys)
        assert rc == 0 and json.loads(out)["num_indexes"] == 0
        rc, out, _ = _run(j_cli.main, ["--config", str(f), "config", "show"], capsys)
        assert rc == 0 and "chunk_size: 512" in out  # the reference drops it
        rc, out, _ = _run(cli.main, ["config", "show", "--config", str(f)], capsys)
        assert "chunk_size: 99" in out


# Every command that touches the engine, with the files it needs.
ENGINE_COMMANDS = [
    ["add", "{proj}"], ["remove", "proj", "-y"], ["search", "hello"], ["list"],
    ["sync"], ["status"], ["workspace", "list"], ["workspace", "create", "ws"], ["mcp"],
    ["ask", "what"], ["build", "{x}", "-o", "{out}"], ["query", "{out}", "{x}", "{x}"],
    ["eval", "{out}", "{x}", "{x}"],
]


@pytest.mark.parametrize("argv", ENGINE_COMMANDS, ids=[" ".join(a[:2]) for a in ENGINE_COMMANDS])
def test_engine_commands_need_the_card(argv, base, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    src = make_proj(base)
    x = tmp_path / "x.npy"
    np.save(x, np.zeros((4, 8), np.float32))
    before = sorted(p for p in tmp_path.rglob("*"))
    argv = [a.format(proj=src, x=x, out=tmp_path / "i.leann") for a in argv]
    rc, out, err = _run(cli.main, argv, capsys)
    assert rc == 1
    assert "no CUDA device" in err and "--device cpu" in err
    assert sorted(p for p in tmp_path.rglob("*")) == before  # nothing written
    assert not Path(base / "islands").exists()
