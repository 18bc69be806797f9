"""Q&A agent (reference: src/agent/): search-first RAG over the indexer.
Port of islands_tpu/agent, with the same exports."""

from islands_tpu_torch.agent.llm import (
    ContextTooLong,
    LlmConfig,
    LlmError,
    LlmProvider,
    Message,
    MockLlmProvider,
    OpenAiProvider,
)
from islands_tpu_torch.agent.prompt import (
    DEFAULT_SYSTEM_PROMPT,
    build_messages,
    format_search_context,
)
from islands_tpu_torch.agent.service import IslandsAgent

__all__ = [
    "ContextTooLong", "DEFAULT_SYSTEM_PROMPT", "IslandsAgent", "LlmConfig",
    "LlmError", "LlmProvider", "Message", "MockLlmProvider", "OpenAiProvider",
    "build_messages", "format_search_context",
]
