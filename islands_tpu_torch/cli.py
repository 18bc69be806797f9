"""islands-tpu-torch CLI: port of islands_tpu/cli.py, the same subcommands,
flags and output.

The port's one addition is the global `--device` (default: the CUDA card),
its counterpart of the reference's JAX_PLATFORMS: every command that
touches the engine runs there, and without a card it fails with the port's
device error instead of running on the CPU; `--device cpu` runs on the CPU.
Search results come back to the host once per call, and the timed windows
of `build` and `eval` wait for the device.

Reference: src/main.rs:20-271 + src/commands.rs — subcommands add / remove /
search / list / sync / config {show,init} / workspace {create,list,delete,
add-repo,remove-repo} / mcp / ask / status, global --debug/--config/--format,
ISLANDS_GIT_TOKEN env for provider tokens.

Adds the engine commands `build`, `query`, `eval` over raw vector files —
the BASELINE harness drives these.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys

import torch

from islands_tpu_torch import output
from islands_tpu_torch.config import Config
from islands_tpu_torch.device import resolve_device


def _device(args) -> torch.device:
    """The engine's device: `--device`, the CUDA card when it is not given.
    Raises without a card; nothing falls back to the CPU."""
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise RuntimeError("no CUDA device is available; pass --device cpu to run "
                           "on the CPU") from e


def _sync(dev: torch.device) -> None:
    """Wait for the work queued on `dev`, so a timed window holds it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _make_service(cfg: Config, args):
    from islands_tpu_torch.indexer.service import IndexerService

    return IndexerService(cfg.indexer_config(), device=_device(args))


# ---------------------------------------------------------------------------
# repository commands (reference: commands.rs)
# ---------------------------------------------------------------------------


def cmd_add(args, cfg: Config) -> int:
    svc = _make_service(cfg, args)
    token = os.environ.get("ISLANDS_GIT_TOKEN")
    clone_url = None
    if token and args.url.startswith("https://"):
        from islands_tpu_torch.providers import ProviderFactory, detect_provider, Repository, ProviderAuth

        try:
            provider = ProviderFactory.create(
                detect_provider(args.url), auth=ProviderAuth.from_token(token)
            )
            clone_url = provider.get_clone_url(Repository.from_url(args.url))
        except Exception:
            clone_url = None
    with output.Spinner(f"indexing {args.url}"):
        info = svc.add_repository(args.url, clone_url=clone_url, branch=args.branch)
    output.success(
        f"indexed {info.name}: {info.num_chunks} chunks from {info.num_files} files"
    )
    return 0


def cmd_remove(args, cfg: Config) -> int:
    svc = _make_service(cfg, args)
    if not args.yes:
        answer = input(f"Remove index '{args.index}'? [y/N] ").strip().lower()
        if answer not in ("y", "yes"):
            output.info("aborted")
            return 1
    svc.remove_index(args.index)
    output.success(f"removed {args.index}")
    return 0


def cmd_search(args, cfg: Config) -> int:
    svc = _make_service(cfg, args)
    hits = svc.search(
        args.query,
        index_names=[args.index] if args.index else None,
        workspace=args.workspace,
        top_k=args.top_k,
    )
    if args.format == "json":
        print(json.dumps(hits, indent=2))
        return 0
    if not hits:
        output.info("no results")
        return 0
    for h in hits:
        print(f"{h['score']:.3f}  {h['index']}  {h['path']}:{h['start_line']}")
        snippet = h["snippet"].strip().splitlines()
        for line in snippet[:3]:
            print(f"    {line}")
    return 0


def cmd_list(args, cfg: Config) -> int:
    svc = _make_service(cfg, args)
    infos = svc.list_indexes()
    if args.format == "json":
        print(json.dumps([i.to_dict() for i in infos], indent=2))
        return 0
    if not infos:
        output.info("no indexes")
        return 0
    print(output.table(
        ["name", "repository", "chunks", "files", "bytes"],
        [[i.name, i.repository, i.num_chunks, i.num_files, i.size_bytes]
         for i in infos],
    ))
    return 0


def cmd_sync(args, cfg: Config) -> int:
    svc = _make_service(cfg, args)
    if args.index:
        info = svc.get_index(args.index)
        changed = svc.sync_repository(info.repository)
        output.success(f"{args.index}: {'re-indexed' if changed else 'up to date'}")
    else:
        n = svc.sync_all()
        output.success(f"synced all; {n} re-indexed")
    return 0


def cmd_status(args, cfg: Config) -> int:
    svc = _make_service(cfg, args)
    st = svc.status()
    if args.format == "json":
        print(json.dumps(st, indent=2))
    else:
        print(f"indexes: {st['num_indexes']}  chunks: {st['total_chunks']}  "
              f"files: {st['total_files']}  bytes: {st['total_size_bytes']}")
    return 0


def cmd_config(args, cfg: Config) -> int:
    if args.config_cmd == "init":
        path = args.path or "islands.yaml"
        with open(path, "w") as f:
            f.write(cfg.to_yaml())
        output.success(f"wrote {path}")
    else:  # show
        print(cfg.to_yaml())
    return 0


def cmd_workspace(args, cfg: Config) -> int:
    svc = _make_service(cfg, args)
    wc = args.workspace_cmd
    if wc == "create":
        svc.create_workspace(args.name, args.description or "")
        output.success(f"created workspace {args.name}")
    elif wc == "list":
        for ws in svc.list_workspaces():
            print(f"{ws['name']}: {len(ws['repositories'])} repos")
    elif wc == "delete":
        svc.delete_workspace(args.name)
        output.success(f"deleted workspace {args.name}")
    elif wc == "add-repo":
        svc.add_repo_to_workspace(args.name, args.repo)
        output.success(f"added {args.repo} to {args.name}")
    elif wc == "remove-repo":
        svc.remove_repo_from_workspace(args.name, args.repo)
        output.success(f"removed {args.repo} from {args.name}")
    return 0


def cmd_mcp(args, cfg: Config) -> int:
    from islands_tpu_torch.mcp import run_server

    svc = _make_service(cfg, args)
    # stdout carries the JSON-RPC responses alone: whatever else is printed
    # while the server runs goes to stderr.
    responses = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        run_server(svc, stdout=responses)
    return 0


def cmd_ask(args, cfg: Config) -> int:
    from islands_tpu_torch.agent import IslandsAgent, LlmConfig, MockLlmProvider, OpenAiProvider

    svc = _make_service(cfg, args)
    if cfg.openai_api_key:
        llm = OpenAiProvider(LlmConfig(api_key=cfg.openai_api_key))
    else:
        output.warning("no OPENAI_API_KEY; using mock LLM")
        llm = MockLlmProvider(["(mock) see the search context above"])
    agent = IslandsAgent(svc, llm, workspace=args.workspace)
    if args.question:
        print(agent.ask(" ".join(args.question)))
        return 0
    # interactive REPL (reference: commands.rs:233-293)
    output.info("interactive mode; 'quit' to exit, 'clear' to reset history")
    while True:
        try:
            q = input("ask> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if q in ("quit", "exit"):
            break
        if q == "clear":
            agent.clear_history()
            output.info("history cleared")
            continue
        if q:
            print(agent.ask(q))
    return 0


# ---------------------------------------------------------------------------
# engine commands
# ---------------------------------------------------------------------------


def _load_vectors(path: str):
    import numpy as np

    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        data = np.load(path)
        return data[list(data.files)[0]]
    raise ValueError(f"unsupported vector file (want .npy/.npz): {path}")


def cmd_build(args, cfg: Config) -> int:
    """Build a LEANN index from raw vectors and save it."""
    from islands_tpu_torch.core.config import DistanceMetric, LeannConfig, PQConfig
    from islands_tpu_torch.core.leann import LeannIndex
    from islands_tpu_torch.core.storage import save_index

    dev = _device(args)
    x = _load_vectors(args.vectors)
    config = LeannConfig(
        m=args.m, m0=2 * args.m, ef_construction=args.ef_construction,
        metric=DistanceMetric(args.metric),
        reverse_slack=2 * args.m, intra_wave_k=args.m,
    )
    idx = LeannIndex(config, device=dev)
    pq = PQConfig(num_subquantizers=args.pq_subquantizers) if args.pq else None
    import time as _t

    t0 = _t.perf_counter()
    idx.build_from_embeddings(x, with_pq=pq)
    _sync(dev)
    dt = _t.perf_counter() - t0
    nbytes = save_index(idx, args.out)
    output.success(
        f"built {x.shape[0]} vectors in {dt:.1f}s "
        f"({x.shape[0]/dt:.0f} vec/s); {nbytes} bytes -> {args.out}"
    )
    return 0


def cmd_query(args, cfg: Config) -> int:
    """Query a saved index with stored/recompute embeddings."""
    from islands_tpu_torch.core.embedding import InMemoryEmbeddingProvider
    from islands_tpu_torch.core.storage import load_index

    dev = _device(args)
    idx = load_index(args.index, device=dev)
    q = _load_vectors(args.queries)
    prov = InMemoryEmbeddingProvider(_load_vectors(args.vectors), device=dev)
    if idx.pq is not None and not args.exact:
        d, i = idx.search_two_level(q, k=args.top_k, provider=prov, ef=args.ef,
                                    promote_width=args.promote_width,
                                    max_iters=args.max_iters,
                                    end_rerank=args.end_rerank)
    else:
        d, i = idx.search(q, k=args.top_k, provider=prov, ef=args.ef,
                          promote_width=args.promote_width,
                          max_iters=args.max_iters)
    # One copy of each result to the host, not a sync per row.
    print(json.dumps({
        "ids": i.cpu().numpy().tolist(), "distances": d.cpu().numpy().tolist(),
    }))
    return 0


def cmd_eval(args, cfg: Config) -> int:
    """Recall@k + QPS against brute force — the BASELINE harness."""
    import time as _t

    import numpy as np

    from islands_tpu_torch.core.embedding import InMemoryEmbeddingProvider
    from islands_tpu_torch.core.storage import load_index
    from islands_tpu_torch.device import to_device
    from islands_tpu_torch.ops import distance as dist_ops

    dev = _device(args)
    idx = load_index(args.index, device=dev)
    x = _load_vectors(args.vectors)
    q = to_device(_load_vectors(args.queries), dev, torch.float32)
    prov = InMemoryEmbeddingProvider(x, device=dev)
    k = args.top_k
    _, true_ids = dist_ops.brute_force_topk(q, prov.embeddings, k, idx.config.metric)
    true_ids = true_ids.cpu().numpy()

    def run():
        if idx.pq is not None and not args.exact:
            return idx.search_two_level(q, k=k, provider=prov, ef=args.ef,
                                        promote_width=args.promote_width,
                                        max_iters=args.max_iters,
                                        end_rerank=args.end_rerank)
        return idx.search(q, k=k, provider=prov, ef=args.ef,
                          promote_width=args.promote_width,
                          max_iters=args.max_iters)

    run()  # warmup
    _sync(dev)
    t0 = _t.perf_counter()
    reps = 3
    for _ in range(reps):
        d, ids = run()
    _sync(dev)
    dt = (_t.perf_counter() - t0) / reps
    ids = ids.cpu().numpy()
    recall = float(np.mean([
        len(set(ids[i].tolist()) & set(true_ids[i].tolist())) / k
        for i in range(len(q))
    ]))
    print(json.dumps({
        "recall": round(recall, 4),
        "qps": round(len(q) / dt, 1),
        "ef": args.ef,
        "k": k,
        "n": int(x.shape[0]),
    }))
    return 0


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


def _global_flags(defaults: bool) -> argparse.ArgumentParser:
    """The global flags. Only the top-level parser sets their defaults: a
    subcommand's parser copies into the namespace every default it holds,
    which would drop the flags given before the subcommand (the reference
    does drop them)."""
    kw = {} if defaults else {"default": argparse.SUPPRESS}
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--debug", action="store_true", **kw)
    common.add_argument("--config", help="config file (yaml/json)", **kw)
    common.add_argument("--format", choices=["text", "json"],
                        **(kw or {"default": "text"}))
    common.add_argument("--device", help="the engine's device: cuda (the default) or cpu",
                        **kw)
    return common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="islands-tpu-torch",
        description="Codebase indexing and semantic search on an NVIDIA GPU",
        parents=[_global_flags(defaults=True)],
    )
    # Global flags accepted both before and after the subcommand
    # (reference: clap global flags, main.rs:20-38).
    common = _global_flags(defaults=False)
    sub = p.add_subparsers(dest="command", parser_class=lambda **kw: argparse.ArgumentParser(parents=[common], **kw))

    sp = sub.add_parser("add", help="clone and index a repository")
    sp.add_argument("url")
    sp.add_argument("--branch")
    sp.set_defaults(fn=cmd_add)

    sp = sub.add_parser("remove", help="remove an index")
    sp.add_argument("index")
    sp.add_argument("-y", "--yes", action="store_true")
    sp.set_defaults(fn=cmd_remove)

    sp = sub.add_parser("search", help="semantic search")
    sp.add_argument("query")
    sp.add_argument("--index")
    sp.add_argument("--workspace")
    sp.add_argument("-k", "--top-k", type=int, default=10)
    sp.set_defaults(fn=cmd_search)

    sp = sub.add_parser("list", help="list indexes")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("sync", help="sync repositories")
    sp.add_argument("index", nargs="?")
    sp.set_defaults(fn=cmd_sync)

    sp = sub.add_parser("status", help="aggregate stats")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("config", help="configuration")
    sp.add_argument("config_cmd", choices=["show", "init"])
    sp.add_argument("--path")
    sp.set_defaults(fn=cmd_config)

    sp = sub.add_parser("workspace", help="workspace management")
    sp.add_argument("workspace_cmd",
                    choices=["create", "list", "delete", "add-repo", "remove-repo"])
    sp.add_argument("name", nargs="?")
    sp.add_argument("repo", nargs="?")
    sp.add_argument("--description")
    sp.set_defaults(fn=cmd_workspace)

    sp = sub.add_parser("mcp", help="run the MCP stdio server")
    sp.set_defaults(fn=cmd_mcp)

    sp = sub.add_parser("ask", help="Q&A over indexed code")
    sp.add_argument("question", nargs="*")
    sp.add_argument("--workspace")
    sp.set_defaults(fn=cmd_ask)

    sp = sub.add_parser("build", help="build an index from raw vectors")
    sp.add_argument("vectors")
    sp.add_argument("-o", "--out", required=True)
    sp.add_argument("--m", type=int, default=30)
    sp.add_argument("--ef-construction", type=int, default=128)
    sp.add_argument("--metric", default="cosine")
    sp.add_argument("--pq", action="store_true")
    sp.add_argument("--pq-subquantizers", type=int, default=8)
    sp.set_defaults(fn=cmd_build)

    sp = sub.add_parser("query", help="query a saved index")
    sp.add_argument("index")
    sp.add_argument("vectors")
    sp.add_argument("queries")
    sp.add_argument("-k", "--top-k", type=int, default=10)
    sp.add_argument("--ef", type=int, default=64)
    sp.add_argument("--exact", action="store_true")
    sp.add_argument("--promote-width", type=int, default=None,
                    help="sketch-gate exact-scoring budget per hop")
    sp.add_argument("--max-iters", type=int, default=None,
                    help="hop-iteration cap (QPS/tail-recall knob, "
                         "design.md #13)")
    sp.add_argument("--end-rerank", action="store_true",
                    help="PQ two-level: pure-ADC hops + one final ef-wide "
                         "exact rescore (design.md #16)")
    sp.set_defaults(fn=cmd_query)

    sp = sub.add_parser("eval", help="recall/QPS eval vs brute force")
    sp.add_argument("index")
    sp.add_argument("vectors")
    sp.add_argument("queries")
    sp.add_argument("-k", "--top-k", type=int, default=10)
    sp.add_argument("--ef", type=int, default=64)
    sp.add_argument("--exact", action="store_true")
    sp.add_argument("--promote-width", type=int, default=None,
                    help="sketch-gate exact-scoring budget per hop")
    sp.add_argument("--max-iters", type=int, default=None,
                    help="hop-iteration cap (QPS/tail-recall knob, "
                         "design.md #13)")
    sp.add_argument("--end-rerank", action="store_true",
                    help="PQ two-level: pure-ADC hops + one final ef-wide "
                         "exact rescore (design.md #16)")
    sp.set_defaults(fn=cmd_eval)

    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = Config.from_file(args.config) if args.config else Config()
    cfg = Config.from_env(cfg)
    if args.debug:
        cfg.debug = True
        cfg.log_level = "debug"
    logging.basicConfig(
        level=getattr(logging, cfg.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if not getattr(args, "fn", None):
        build_parser().print_help()
        return 1
    try:
        return args.fn(args, cfg)
    except KeyboardInterrupt:
        return 130
    except Exception as e:
        if cfg.debug:
            raise
        output.error(str(e))
        return 1


if __name__ == "__main__":
    sys.exit(main())
