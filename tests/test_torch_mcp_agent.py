"""The port's MCP server and agent against tests/test_mcp_agent.py's cases.

The reference's IndexerService (hash embedder) indexes a small tree once;
each package's McpServer then runs over its own service on that base path,
and the same request lines must give the same response lines, errors
included. Scores reach the responses only as text rounded to 3 places, so
equal lines hold them within 5e-4; the raw scores under them are held
within 1e-5. The agent's prompt assembly and its ask / ask_stream /
clear_history with the mock LLM must give the same strings and histories."""

import io
import json
import re
import shutil

import numpy as np
import pytest

from islands_tpu import agent as j_agent
from islands_tpu.indexer import IndexerConfig as JIndexerConfig
from islands_tpu.indexer import IndexerService as JIndexerService
from islands_tpu.mcp import McpServer as JMcpServer
from islands_tpu_torch import agent
from islands_tpu_torch.indexer import IndexerConfig, IndexerService
from islands_tpu_torch.mcp import McpServer
from islands_tpu_torch.mcp.protocol import INVALID_REQUEST, METHOD_NOT_FOUND, PARSE_ERROR


def _make_proj(root):
    (root / "src").mkdir(parents=True)
    (root / "src" / "engine.py").write_text(
        "def beam_search(query, graph):\n    return graph.search(query)\n"
    )
    (root / "src" / "dist.py").write_text(
        "def distance(a, b):\n    return sum((x - y) ** 2 for x, y in zip(a, b))\n"
    )
    (root / "README.md").write_text("# proj\nvector search engine\n")


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A base path the reference's service indexed."""
    tmp = tmp_path_factory.mktemp("mcp")
    _make_proj(tmp / "proj")
    base = tmp / "islands"
    JIndexerService(JIndexerConfig(base_path=str(base))).index_local_path(tmp / "proj", "proj")
    return base


def _services(base):
    return (JIndexerService(JIndexerConfig(base_path=str(base))),
            IndexerService(IndexerConfig(base_path=str(base)), device="cpu"))


@pytest.fixture(scope="module")
def servers(base):
    j_svc, svc = _services(base)
    return JMcpServer(j_svc), McpServer(svc)


def _line(method, params=None, id=1):
    return json.dumps({"jsonrpc": "2.0", "id": id, "method": method,
                       **({"params": params} if params is not None else {})})


def _call(name, arguments=None, id=1):
    return _line("tools/call", {"name": name, **({"arguments": arguments}
                                                  if arguments is not None else {})}, id)


# (case, request line, what the response must be)
LINES = [
    ("initialize", _line("initialize", {"protocolVersion": "2024-11-05"}), "result"),
    ("initialized", json.dumps({"jsonrpc": "2.0", "method": "initialized"}), None),
    ("notifications/initialized",
     json.dumps({"jsonrpc": "2.0", "method": "notifications/initialized"}), None),
    ("tools/list", _line("tools/list", id="a"), "result"),
    ("ping", _line("ping", id=7), "result"),
    ("unknown method", _line("nope/nothing"), METHOD_NOT_FOUND),
    ("parse error", "{not json", PARSE_ERROR),
    ("invalid request", json.dumps({"jsonrpc": "1.0", "id": 1}), INVALID_REQUEST),
    ("non-object", "[1, 2, 3]", INVALID_REQUEST),
    ("missing method", json.dumps({"jsonrpc": "2.0", "id": 5}), INVALID_REQUEST),
    ("blank", "   ", None),
    ("missing tool name", _line("tools/call", {}), -32602),
    ("islands_list", _call("islands_list"), "result"),
    ("islands_search", _call("islands_search", {"query": "beam search engine", "top_k": 3}),
     "result"),
    ("islands_search indexes", _call("islands_search", {"query": "distance between vectors",
                                                        "indexes": ["proj"]}), "result"),
    ("islands_search nothing", _call("islands_search", {"query": "q", "indexes": ["ghost"]}),
     "result"),
    ("islands_search missing query", _call("islands_search", {}), "isError"),
    ("islands_status all", _call("islands_status"), "result"),
    ("islands_status one", _call("islands_status", {"index_name": "proj"}), "result"),
    ("islands_sync missing index", _call("islands_sync", {"index_name": "ghost"}), "isError"),
    ("islands_status missing index", _call("islands_status", {"index_name": "ghost"}),
     "isError"),
    ("islands_add_repo missing url", _call("islands_add_repo", {}), "isError"),
    ("islands_remove missing name", _call("islands_remove", {}), "isError"),
    ("unknown tool", _call("islands_nope"), METHOD_NOT_FOUND),
]


@pytest.mark.parametrize("line,want", [c[1:] for c in LINES], ids=[c[0] for c in LINES])
def test_same_response_line(servers, line, want):
    j_server, server = servers
    got, ref = server.handle_line(line), j_server.handle_line(line)
    assert got == ref
    if want is None:
        assert got is None
        return
    resp = json.loads(got)
    if want == "result":
        assert "result" in resp and not resp["result"].get("isError")
    elif want == "isError":
        assert resp["result"]["isError"] is True
    else:
        assert resp["error"]["code"] == want


def test_search_hits_and_raw_scores_agree(base):
    """The tool's text carries scores to 3 places; the hits under it agree
    in order and within 1e-5 in score."""
    j_svc, svc = _services(base)
    for query in ("beam search engine", "distance between vectors", "vector search"):
        want, got = j_svc.search(query, top_k=3), svc.search(query, top_k=3)
        assert [(h["path"], h["start_line"]) for h in got] == [
            (h["path"], h["start_line"]) for h in want]
        np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in want],
                                   atol=1e-5, rtol=0)
        text = McpServer(svc).tools.call_tool("islands_search", {"query": query,
                                                                 "top_k": 3})
        shown = [float(s) for s in re.findall(r"score (-?\d+\.\d+)",
                                              text["content"][0]["text"])]
        np.testing.assert_allclose(shown, [h["score"] for h in want], atol=5e-4, rtol=0)


def test_stdio_loop(base):
    stdin_text = "".join(line + "\n" for line in (
        _line("initialize", id=1), json.dumps({"jsonrpc": "2.0", "method": "initialized"}),
        _line("tools/list", id=2), "{bad", _call("islands_list", id=3),
        _line("shutdown", id=4), _line("tools/list", id=5)))
    outs = []
    for server in (JMcpServer(_services(base)[0]), McpServer(_services(base)[1])):
        stdout = io.StringIO()
        server.run_stdio(io.StringIO(stdin_text), stdout)
        outs.append(stdout.getvalue())
    assert outs[1] == outs[0]
    lines = [json.loads(l) for l in outs[1].splitlines()]
    # shutdown stops the loop: id=5 is never answered
    assert [l["id"] for l in lines] == [1, 2, None, 3, 4]


def test_remove_then_list(base, tmp_path):
    """Tools that change the service, each package on its own copy of the
    base path."""
    outs = []
    for i, (Server, svc_of) in enumerate((
            (JMcpServer, lambda b: JIndexerService(JIndexerConfig(base_path=str(b)))),
            (McpServer, lambda b: IndexerService(IndexerConfig(base_path=str(b)),
                                                 device="cpu")))):
        copy = tmp_path / f"copy{i}"
        shutil.copytree(base, copy)
        server = Server(svc_of(copy))
        outs.append([server.handle_line(l) for l in (
            _call("islands_remove", {"index_name": "proj"}), _call("islands_list"),
            _call("islands_search", {"query": "beam"}), _call("islands_status"))])
    assert outs[1] == outs[0]
    assert "Removed" in json.loads(outs[1][0])["result"]["content"][0]["text"]
    assert "No indexes" in json.loads(outs[1][1])["result"]["content"][0]["text"]


class TestPrompt:
    @pytest.mark.parametrize("n,snippet", [(8, "x" * 2000), (3, "def f():\n    pass"), (0, "")])
    def test_format_search_context(self, n, snippet):
        results = [{"path": f"f{i}.py", "start_line": i, "snippet": snippet,
                    "score": 0.9 - 0.01 * i} for i in range(n)]
        ctx = agent.format_search_context(results)
        assert ctx == j_agent.format_search_context(results)
        if n == 8:
            assert ctx.count("---") == 2 * 5  # top 5 only
            assert "x" * 1001 not in ctx  # 1000-char truncate

    def test_format_missing_keys(self):
        results = [{}, {"path": "a.py"}]
        assert agent.format_search_context(results) == j_agent.format_search_context(results)

    @pytest.mark.parametrize("n_history", [0, 4, 15])
    def test_build_messages(self, n_history):
        def msgs(mod):
            history = [mod.Message.user(f"q{i}") if i % 2 == 0 else mod.Message.assistant(f"a{i}")
                       for i in range(n_history)]
            return [m.to_dict() for m in mod.build_messages("question", "CTX", history)]

        got = msgs(agent)
        assert got == msgs(j_agent)
        assert got[0] == {"role": "system", "content": agent.DEFAULT_SYSTEM_PROMPT}
        assert len(got) == 3 + min(n_history, 10)
        assert got[-2:] == [{"role": "system", "content": "CTX"},
                            {"role": "user", "content": "question"}]

    def test_constants(self):
        assert agent.DEFAULT_SYSTEM_PROMPT == j_agent.DEFAULT_SYSTEM_PROMPT
        assert agent.__all__ == j_agent.__all__


class TestAgent:
    def _run(self, base, script):
        """script(agent_module, agent, llm) on each package's agent over its
        own service; returns (what script returned, history, LLM calls)."""
        outs = []
        for mod, svc in zip((j_agent, agent), _services(base)):
            llm = mod.MockLlmProvider(["The beam_search function searches the graph.", "ok"])
            a = mod.IslandsAgent(svc, llm)
            ret = script(mod, a, llm)
            outs.append((ret, [m.to_dict() for m in a.history],
                         [[m.to_dict() for m in call] for call in llm.calls]))
        assert outs[1] == outs[0]
        return outs[1]

    def test_ask_flow(self, base):
        ret, history, calls = self._run(base, lambda mod, a, llm: a.ask("what does beam_search do?"))
        assert "beam_search" in ret
        assert calls[0][0]["role"] == "system"
        assert any("engine.py" in m["content"] for m in calls[0])
        assert calls[0][-1]["content"] == "what does beam_search do?"
        assert len(history) == 2

    def test_history_window(self, base):
        _, history, calls = self._run(
            base, lambda mod, a, llm: [a.ask(f"question {i}") for i in range(7)])
        assert len(history) == 14
        assert len(calls[-1]) == 3 + 10

    def test_ask_stream_and_clear(self, base):
        def script(mod, a, llm):
            chunks = list(a.ask_stream("q"))
            hist = [m.to_dict() for m in a.history]
            a.clear_history()
            return chunks, hist

        (chunks, hist), history, _ = self._run(base, script)
        assert "".join(chunks).strip() == "The beam_search function searches the graph."
        assert hist[-1]["role"] == "assistant"
        assert history == []

    def test_agent_gets_full_snippets(self, base):
        seen = []
        for mod, svc in zip((j_agent, agent), _services(base)):
            orig = svc.search
            svc.search = lambda *a, **kw: (seen.append(kw), orig(*a, **kw))[1]
            mod.IslandsAgent(svc, mod.MockLlmProvider(), workspace=None).ask("anything")
        assert seen[1] == seen[0]
        assert seen[1]["snippet_chars"] == 1000

    def test_openai_provider(self):
        for mod in (j_agent, agent):
            with pytest.raises(mod.LlmError):
                mod.OpenAiProvider(mod.LlmConfig(api_key=None))
        msgs = [agent.Message.system("s"), agent.Message.user("u")]
        j_msgs = [j_agent.Message.system("s"), j_agent.Message.user("u")]
        for stream in (False, True):
            assert (agent.OpenAiProvider(agent.LlmConfig(api_key="k"))._request_body(msgs, stream)
                    == j_agent.OpenAiProvider(j_agent.LlmConfig(api_key="k"))._request_body(
                        j_msgs, stream))
