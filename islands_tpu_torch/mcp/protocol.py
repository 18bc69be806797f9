"""MCP protocol types: JSON-RPC 2.0 + Model Context Protocol structures.

Port of islands_tpu/mcp/protocol.py, a copy: the module is framework-free, but
importing islands_tpu pulls in jax.

Reference: src/mcp/protocol.rs:8-227 — protocol version "2024-11-05",
Initialize params/result, capabilities, Tool descriptors, CallTool
params/result, text/image/resource content items, JSON-RPC error codes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

MCP_PROTOCOL_VERSION = "2024-11-05"
JSONRPC_VERSION = "2.0"

# JSON-RPC 2.0 error codes (reference: mcp/error.rs:10-79)
PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603


@dataclasses.dataclass
class JsonRpcRequest:
    method: str
    id: int | str | None = None
    params: dict | None = None
    jsonrpc: str = JSONRPC_VERSION

    @staticmethod
    def from_dict(d: dict) -> "JsonRpcRequest":
        if not isinstance(d, dict) or d.get("jsonrpc") != JSONRPC_VERSION:
            raise ValueError("invalid JSON-RPC request")
        if "method" not in d or not isinstance(d["method"], str):
            raise ValueError("missing method")
        return JsonRpcRequest(
            method=d["method"], id=d.get("id"), params=d.get("params"),
        )

    @property
    def is_notification(self) -> bool:
        return self.id is None


def make_response(request_id, result: Any) -> dict:
    return {"jsonrpc": JSONRPC_VERSION, "id": request_id, "result": result}


def make_error(request_id, code: int, message: str, data: Any = None) -> dict:
    err: dict = {"code": code, "message": message}
    if data is not None:
        err["data"] = data
    return {"jsonrpc": JSONRPC_VERSION, "id": request_id, "error": err}


@dataclasses.dataclass
class Tool:
    """Tool descriptor (reference: protocol.rs Tool struct)."""

    name: str
    description: str
    input_schema: dict

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "inputSchema": self.input_schema,
        }


def text_content(text: str) -> dict:
    """ContentItem::Text (reference: protocol.rs ContentItem)."""
    return {"type": "text", "text": text}


def tool_result(content: list[dict], is_error: bool = False) -> dict:
    """CallToolResult; tool failures are SUCCESS responses with is_error=true
    (reference: server.rs:150-165)."""
    out: dict = {"content": content}
    if is_error:
        out["isError"] = True
    return out


def initialize_result(server_name: str, server_version: str) -> dict:
    """(reference: server.rs:104-123)"""
    return {
        "protocolVersion": MCP_PROTOCOL_VERSION,
        "capabilities": {"tools": {"listChanged": False}},
        "serverInfo": {"name": server_name, "version": server_version},
    }
