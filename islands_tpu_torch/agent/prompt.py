"""Agent prompt assembly (reference: src/agent/prompt.rs:4-77). Port of
islands_tpu/agent/prompt.py, a copy."""

from __future__ import annotations

from islands_tpu_torch.agent.llm import Message

DEFAULT_SYSTEM_PROMPT = """\
You are a codebase assistant. You answer questions about indexed code
repositories using the search results provided as context. Cite file paths
and line numbers when referring to code. If the context does not contain the
answer, say so rather than guessing."""

#: top-N results included in context (reference: prompt.rs format_search_context)
CONTEXT_RESULTS = 5
#: per-result snippet truncation (reference: 1000-char truncate)
SNIPPET_LIMIT = 1000
#: conversation history window (reference: last 10 messages)
HISTORY_LIMIT = 10


def format_search_context(results: list[dict]) -> str:
    """Top-5 results, 1000-char snippets (reference: prompt.rs:30-55)."""
    if not results:
        return "No relevant code found in the indexed repositories."
    parts = ["Relevant code from the indexed repositories:\n"]
    for r in results[:CONTEXT_RESULTS]:
        snippet = r.get("snippet", "")[:SNIPPET_LIMIT]
        loc = f"{r.get('path', '?')}:{r.get('start_line', '?')}"
        parts.append(f"--- {loc} (score {r.get('score', 0):.3f}) ---\n{snippet}\n")
    return "\n".join(parts)


def build_messages(
    question: str,
    context: str,
    history: list[Message] | None = None,
    system_prompt: str = DEFAULT_SYSTEM_PROMPT,
) -> list[Message]:
    """system + last-10 history + context-as-system + user
    (reference: prompt.rs:58-77)."""
    messages = [Message.system(system_prompt)]
    if history:
        messages.extend(history[-HISTORY_LIMIT:])
    messages.append(Message.system(context))
    messages.append(Message.user(question))
    return messages
