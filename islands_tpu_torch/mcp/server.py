"""MCP stdio server: line-delimited JSON-RPC loop.

Port of islands_tpu/mcp/server.py, a copy: the module is framework-free, but
importing islands_tpu pulls in jax.

Reference: src/mcp/server.rs:19-168 — stdin/stdout line protocol, methods
initialize / initialized / tools/list / tools/call / shutdown; unknown
methods -> -32601; tool errors returned as SUCCESS with is_error=true;
notifications get no response.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import TextIO

from islands_tpu_torch.mcp.protocol import (
    INTERNAL_ERROR,
    INVALID_PARAMS,
    INVALID_REQUEST,
    METHOD_NOT_FOUND,
    PARSE_ERROR,
    JsonRpcRequest,
    initialize_result,
    make_error,
    make_response,
)
from islands_tpu_torch.mcp.tools import IslandsTools, ToolNotFound

logger = logging.getLogger("islands_tpu_torch.mcp")

SERVER_NAME = "islands-tpu"
SERVER_VERSION = "0.1.0"


class McpServer:
    def __init__(self, service):
        self.service = service
        self.tools = IslandsTools(service)
        self._shutdown = False

    # -- request handling (reference: server.rs:79-168) --------------------

    def handle_request(self, req: JsonRpcRequest) -> dict | None:
        """Returns a response dict, or None for notifications."""
        try:
            if req.method == "initialize":
                result = initialize_result(SERVER_NAME, SERVER_VERSION)
            elif req.method in ("initialized", "notifications/initialized"):
                return None  # notification, no response
            elif req.method == "tools/list":
                result = {"tools": [t.to_dict() for t in self.tools.list_tools()]}
            elif req.method == "tools/call":
                params = req.params or {}
                name = params.get("name")
                if not name:
                    return make_error(req.id, INVALID_PARAMS, "missing tool name")
                try:
                    result = self.tools.call_tool(name, params.get("arguments"))
                except ToolNotFound:
                    return make_error(
                        req.id, METHOD_NOT_FOUND, f"unknown tool: {name}"
                    )
            elif req.method == "shutdown":
                self._shutdown = True
                result = None
            elif req.method == "ping":
                result = {}
            else:
                return make_error(
                    req.id, METHOD_NOT_FOUND, f"method not found: {req.method}"
                )
        except Exception as e:
            logger.exception("internal error handling %s", req.method)
            return make_error(req.id, INTERNAL_ERROR, str(e))
        if req.is_notification:
            return None
        return make_response(req.id, result)

    def handle_line(self, line: str) -> str | None:
        """One protocol step: JSON line in -> JSON line out (or None)."""
        line = line.strip()
        if not line:
            return None
        try:
            raw = json.loads(line)
        except json.JSONDecodeError as e:
            return json.dumps(make_error(None, PARSE_ERROR, f"parse error: {e}"))
        if not isinstance(raw, dict):
            return json.dumps(make_error(None, INVALID_REQUEST, "request must be an object"))
        try:
            req = JsonRpcRequest.from_dict(raw)
        except ValueError as e:
            return json.dumps(make_error(raw.get("id"), INVALID_REQUEST, str(e)))
        resp = self.handle_request(req)
        return json.dumps(resp) if resp is not None else None

    # -- stdio loop (reference: run_stdio, server.rs:39-76) ----------------

    def run_stdio(self, stdin: TextIO | None = None, stdout: TextIO | None = None) -> None:
        stdin = stdin if stdin is not None else sys.stdin
        stdout = stdout if stdout is not None else sys.stdout
        logger.info("MCP server on stdio (protocol %s)", SERVER_VERSION)
        for line in stdin:
            out = self.handle_line(line)
            if out is not None:
                stdout.write(out + "\n")
                stdout.flush()
            if self._shutdown:
                break


def run_server(service, **kwargs) -> None:
    """(reference: run_server, src/mcp/mod.rs)"""
    McpServer(service).run_stdio(**kwargs)
