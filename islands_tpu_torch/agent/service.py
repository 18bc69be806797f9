"""Search-first RAG agent (reference: src/agent/service.rs:12-131).

Port of islands_tpu/agent/service.py, a copy: the module is framework-free, but
importing islands_tpu pulls in jax.

`ask` = top-5 semantic search -> context formatting -> LLM completion, with
conversation history (last 10 messages used). The reference's streaming
variant uses an unsafe raw-pointer finish callback (service.rs:105-112);
here streaming is just a generator.
"""

from __future__ import annotations

from typing import Iterator

from islands_tpu_torch.agent.llm import LlmProvider, Message
from islands_tpu_torch.agent.prompt import (
    CONTEXT_RESULTS,
    DEFAULT_SYSTEM_PROMPT,
    build_messages,
    format_search_context,
)


class IslandsAgent:
    def __init__(
        self,
        service,
        llm: LlmProvider,
        system_prompt: str = DEFAULT_SYSTEM_PROMPT,
        workspace: str | None = None,
    ):
        self.service = service
        self.llm = llm
        self.system_prompt = system_prompt
        self.workspace = workspace
        self.history: list[Message] = []

    def _context_for(self, question: str) -> str:
        from islands_tpu_torch.agent.prompt import SNIPPET_LIMIT

        results = self.service.search(
            question, workspace=self.workspace, top_k=CONTEXT_RESULTS,
            snippet_chars=SNIPPET_LIMIT,
        )
        return format_search_context(results)

    def ask(self, question: str) -> str:
        """(reference: service.rs:49-74)"""
        context = self._context_for(question)
        messages = build_messages(
            question, context, self.history, self.system_prompt
        )
        answer = self.llm.complete(messages)
        self.history.append(Message.user(question))
        self.history.append(Message.assistant(answer))
        return answer

    def ask_stream(self, question: str) -> Iterator[str]:
        """(reference: service.rs:77-131, sans the unsafe callback)"""
        context = self._context_for(question)
        messages = build_messages(
            question, context, self.history, self.system_prompt
        )
        parts: list[str] = []
        for chunk in self.llm.complete_stream(messages):
            parts.append(chunk)
            yield chunk
        self.history.append(Message.user(question))
        self.history.append(Message.assistant("".join(parts)))

    def clear_history(self) -> None:
        self.history.clear()
