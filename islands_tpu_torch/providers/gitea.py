"""Gitea / self-hosted provider (reference: src/providers/gitea.rs).

Port of islands_tpu/providers/gitea.py, a copy: the module is framework-free, but
importing islands_tpu pulls in jax.

Requires an explicit base_url (self-hosted); webhooks via `x-gitea-event`
(with `x-gogs-event` compatibility) + HMAC `x-gitea-signature`
(gitea.rs:124,311-316).
"""

from __future__ import annotations

import hashlib
import hmac
import json
from typing import Iterator

from islands_tpu_torch.providers.base import (
    ci_header as _ci_get,
    ConfigurationError,
    GitProvider,
    ProviderConfig,
    Repository,
    WebhookEvent,
    WebhookParseError,
)


class GiteaProvider(GitProvider):
    def __init__(self, config: ProviderConfig | None = None):
        super().__init__(config)
        if not self.config.base_url:
            raise ConfigurationError("gitea requires an explicit base_url")

    @property
    def provider_name(self) -> str:
        return "gitea"

    @property
    def base_url(self) -> str:
        return self.config.base_url.rstrip("/") + "/api/v1"

    def build_auth_headers(self) -> dict[str, str]:
        auth = self.config.auth
        if auth and auth.token:
            return {"Authorization": f"token {auth.token}"}
        return {}

    def verify_webhook(self, headers: dict[str, str], body: bytes, secret: str) -> bool:
        # Gitea sends a bare hex HMAC-SHA256 (no "sha256=" prefix).
        sig = _ci_get(headers, "x-gitea-signature") or ""
        expected = hmac.new(secret.encode(), body, hashlib.sha256).hexdigest()
        return hmac.compare_digest(sig, expected)

    def parse_webhook(self, headers: dict[str, str], body: bytes) -> WebhookEvent:
        event_type = _ci_get(headers, "x-gitea-event") or _ci_get(headers, "x-gogs-event")
        if not event_type:
            raise WebhookParseError("missing x-gitea-event header")
        try:
            payload = json.loads(body)
        except json.JSONDecodeError as e:
            raise WebhookParseError(f"invalid JSON payload: {e}") from e
        repo_raw = payload.get("repository") or {}
        full = repo_raw.get("full_name", "/")
        owner, _, name = full.partition("/")
        repo = Repository.new(
            "gitea", owner or "unknown", name or "unknown",
            repo_raw.get("clone_url", ""),
        )
        repo.default_branch = repo_raw.get("default_branch", "main")
        return WebhookEvent(
            event_type=event_type,
            repository=repo,
            ref_name=payload.get("ref"),
            before=payload.get("before"),
            after=payload.get("after"),
            payload=payload,
        )

    def get_repository(self, owner: str, name: str) -> Repository:
        return self._repo_from_api(self.get(f"/repos/{owner}/{name}"))

    def list_repositories(self, owner: str) -> Iterator[Repository]:
        page = 1
        while True:
            raws = self.get(f"/users/{owner}/repos?limit=50&page={page}")
            if not raws:
                return
            for raw in raws:
                yield self._repo_from_api(raw)
            page += 1

    def get_latest_commit(self, owner: str, name: str, branch: str) -> str:
        raw = self.get(f"/repos/{owner}/{name}/branches/{branch}")
        return raw["commit"]["id"]

    @staticmethod
    def _repo_from_api(raw: dict) -> Repository:
        owner = (raw.get("owner") or {}).get("login", "")
        return Repository(
            provider="gitea",
            owner=owner,
            name=raw.get("name", ""),
            clone_url=raw.get("clone_url", ""),
            ssh_url=raw.get("ssh_url"),
            default_branch=raw.get("default_branch", "main"),
            description=raw.get("description"),
            is_private=raw.get("private", False),
        )
