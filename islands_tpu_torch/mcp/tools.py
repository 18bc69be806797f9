"""MCP tools over the indexer service.

Port of islands_tpu/mcp/tools.py, a copy: the module is framework-free, but
importing islands_tpu pulls in jax.

Reference: src/mcp/tools.rs — 6 tools (`islands_list`, `islands_search`,
`islands_add_repo`, `islands_sync`, `islands_status`, `islands_remove`) with
JSON schemas (:28-133) and handlers formatting markdown/JSON text content
(:136-416).
"""

from __future__ import annotations

import json
from typing import Any

from islands_tpu_torch.mcp.protocol import Tool, text_content, tool_result


class ToolNotFound(KeyError):
    pass


class IslandsTools:
    """Tool registry + dispatch (reference IslandsTools, tools.rs:20-133)."""

    def __init__(self, service):
        self.service = service

    # -- registry ----------------------------------------------------------

    @staticmethod
    def list_tools() -> list[Tool]:
        obj = lambda props, req: {
            "type": "object", "properties": props, "required": req,
        }
        return [
            Tool(
                "islands_list",
                "List all indexed repositories with their stats",
                obj({}, []),
            ),
            Tool(
                "islands_search",
                "Semantic search across indexed repositories",
                obj(
                    {
                        "query": {"type": "string", "description": "search query"},
                        "indexes": {
                            "type": "array", "items": {"type": "string"},
                            "description": "restrict to these index names",
                        },
                        "top_k": {
                            "type": "integer", "description": "max results",
                            "default": 10,
                        },
                    },
                    ["query"],
                ),
            ),
            Tool(
                "islands_add_repo",
                "Clone and index a repository by URL",
                obj({"url": {"type": "string"}}, ["url"]),
            ),
            Tool(
                "islands_sync",
                "Sync a repository and re-index if it changed",
                obj({"index_name": {"type": "string"}}, ["index_name"]),
            ),
            Tool(
                "islands_status",
                "Status of one index or aggregate stats for all",
                obj({"index_name": {"type": "string"}}, []),
            ),
            Tool(
                "islands_remove",
                "Remove an index and its repository",
                obj({"index_name": {"type": "string"}}, ["index_name"]),
            ),
        ]

    def call_tool(self, name: str, arguments: dict | None) -> dict:
        """Dispatch; tool errors return success with is_error=true
        (reference: server.rs:150-165)."""
        args = arguments or {}
        handlers = {
            "islands_list": self._list,
            "islands_search": self._search,
            "islands_add_repo": self._add_repo,
            "islands_sync": self._sync,
            "islands_status": self._status,
            "islands_remove": self._remove,
        }
        if name not in handlers:
            raise ToolNotFound(name)
        try:
            return handlers[name](args)
        except Exception as e:
            return tool_result([text_content(f"Error: {e}")], is_error=True)

    # -- handlers (reference: tools.rs:136-416) ----------------------------

    def _list(self, args: dict) -> dict:
        infos = self.service.list_indexes()
        if not infos:
            return tool_result([text_content("No indexes. Use islands_add_repo.")])
        lines = ["# Indexed repositories", ""]
        for i in infos:
            lines.append(
                f"- **{i.name}** ({i.repository}): {i.num_chunks} chunks, "
                f"{i.num_files} files, {i.size_bytes} bytes"
            )
        return tool_result([text_content("\n".join(lines))])

    def _search(self, args: dict) -> dict:
        query = args.get("query")
        if not query or not isinstance(query, str):
            return tool_result([text_content("Error: 'query' is required")], is_error=True)
        hits = self.service.search(
            query,
            index_names=args.get("indexes"),
            top_k=int(args.get("top_k", 10)),
        )
        if not hits:
            return tool_result([text_content("No results.")])
        lines = [f"# Search results for: {query}", ""]
        for h in hits:
            lines.append(
                f"## {h['path']}:{h['start_line']} (score {h['score']:.3f}, "
                f"index {h['index']})"
            )
            lines.append("```")
            lines.append(h["snippet"])
            lines.append("```")
        return tool_result([text_content("\n".join(lines))])

    def _add_repo(self, args: dict) -> dict:
        url = args.get("url")
        if not url:
            return tool_result([text_content("Error: 'url' is required")], is_error=True)
        info = self.service.add_repository(url)
        return tool_result([text_content(
            f"Indexed **{info.name}**: {info.num_chunks} chunks from "
            f"{info.num_files} files."
        )])

    def _sync(self, args: dict) -> dict:
        name = args.get("index_name")
        if not name:
            return tool_result([text_content("Error: 'index_name' is required")], is_error=True)
        info = self.service.get_index(name)
        reindexed = self.service.sync_repository(info.repository)
        msg = "re-indexed" if reindexed else "up to date"
        return tool_result([text_content(f"**{name}**: {msg}.")])

    def _status(self, args: dict) -> dict:
        name = args.get("index_name")
        if name:
            info = self.service.get_index(name)
            return tool_result([text_content(json.dumps(info.to_dict(), indent=2))])
        return tool_result([text_content(json.dumps(self.service.status(), indent=2))])

    def _remove(self, args: dict) -> dict:
        name = args.get("index_name")
        if not name:
            return tool_result([text_content("Error: 'index_name' is required")], is_error=True)
        self.service.remove_index(name)
        return tool_result([text_content(f"Removed index **{name}**.")])
