"""MCP stdio server (reference: src/mcp/): JSON-RPC 2.0 protocol, tool
registry, line-delimited stdio loop. Port of islands_tpu/mcp, with the same
exports; its tools call the port's IndexerService."""

from islands_tpu_torch.mcp.protocol import (
    JSONRPC_VERSION,
    MCP_PROTOCOL_VERSION,
    JsonRpcRequest,
    Tool,
    make_error,
    make_response,
    text_content,
    tool_result,
)
from islands_tpu_torch.mcp.server import McpServer, run_server
from islands_tpu_torch.mcp.tools import IslandsTools, ToolNotFound

__all__ = [
    "IslandsTools", "JSONRPC_VERSION", "JsonRpcRequest",
    "MCP_PROTOCOL_VERSION", "McpServer", "Tool", "ToolNotFound",
    "make_error", "make_response", "run_server", "text_content", "tool_result",
]
