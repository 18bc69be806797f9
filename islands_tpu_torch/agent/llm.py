"""LLM provider abstraction for the Q&A agent.

Port of islands_tpu/agent/llm.py, a copy: the module is framework-free, but
importing islands_tpu pulls in jax.

Reference: src/agent/llm.rs — `Message` roles (:11-34), `LlmConfig`
(model=gpt-4o, temperature=0.1, max_tokens=4096; :36-60), the `LlmProvider`
trait with complete/complete_stream (:62-90), and the OpenAI chat-completions
backend behind the `openai` feature (:291-330).

`OpenAiProvider` implements the chat-completions wire format and needs
network access and an api_key at run time; tests use `MockLlmProvider`
exactly as the reference does (agent/service.rs:143-178).
"""

from __future__ import annotations

import dataclasses
import json
import urllib.request
from typing import Iterator, Protocol, runtime_checkable


class LlmError(Exception):
    """(reference: agent/error.rs:12-36)"""


class ContextTooLong(LlmError):
    pass


@dataclasses.dataclass
class Message:
    role: str  # "system" | "user" | "assistant"
    content: str

    @staticmethod
    def system(content: str) -> "Message":
        return Message("system", content)

    @staticmethod
    def user(content: str) -> "Message":
        return Message("user", content)

    @staticmethod
    def assistant(content: str) -> "Message":
        return Message("assistant", content)

    def to_dict(self) -> dict:
        return {"role": self.role, "content": self.content}


@dataclasses.dataclass
class LlmConfig:
    model: str = "gpt-4o"
    temperature: float = 0.1
    max_tokens: int = 4096
    api_key: str | None = None
    base_url: str = "https://api.openai.com/v1"


@runtime_checkable
class LlmProvider(Protocol):
    def complete(self, messages: list[Message]) -> str: ...

    def complete_stream(self, messages: list[Message]) -> Iterator[str]: ...


class MockLlmProvider:
    """Canned-response provider for tests (reference: agent/service.rs:143-178)."""

    def __init__(self, responses: list[str] | None = None):
        self.responses = responses or ["mock response"]
        self.calls: list[list[Message]] = []
        self._i = 0

    def complete(self, messages: list[Message]) -> str:
        self.calls.append(list(messages))
        resp = self.responses[min(self._i, len(self.responses) - 1)]
        self._i += 1
        return resp

    def complete_stream(self, messages: list[Message]) -> Iterator[str]:
        resp = self.complete(messages)
        for word in resp.split(" "):
            yield word + " "


class OpenAiProvider:
    """OpenAI chat-completions backend (reference: llm.rs:291-330+).

    Wire-format complete; requires network egress + api_key at runtime."""

    def __init__(self, config: LlmConfig | None = None):
        self.config = config or LlmConfig()
        if not self.config.api_key:
            raise LlmError("OpenAI provider requires api_key")

    def _request_body(self, messages: list[Message], stream: bool) -> dict:
        return {
            "model": self.config.model,
            "messages": [m.to_dict() for m in messages],
            "temperature": self.config.temperature,
            "max_tokens": self.config.max_tokens,
            "stream": stream,
        }

    def complete(self, messages: list[Message]) -> str:  # pragma: no cover - network
        req = urllib.request.Request(
            f"{self.config.base_url}/chat/completions",
            data=json.dumps(self._request_body(messages, False)).encode(),
            headers={
                "Authorization": f"Bearer {self.config.api_key}",
                "Content-Type": "application/json",
            },
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            raw = json.loads(r.read())
        try:
            return raw["choices"][0]["message"]["content"]
        except (KeyError, IndexError) as e:
            raise LlmError(f"malformed completion response: {e}") from e

    def complete_stream(self, messages: list[Message]) -> Iterator[str]:  # pragma: no cover - network
        req = urllib.request.Request(
            f"{self.config.base_url}/chat/completions",
            data=json.dumps(self._request_body(messages, True)).encode(),
            headers={
                "Authorization": f"Bearer {self.config.api_key}",
                "Content-Type": "application/json",
                "Accept": "text/event-stream",
            },
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=300) as r:
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                payload = line[6:]
                if payload == "[DONE]":
                    return
                try:
                    delta = json.loads(payload)["choices"][0]["delta"]
                except (json.JSONDecodeError, KeyError, IndexError):
                    continue
                if "content" in delta:
                    yield delta["content"]
