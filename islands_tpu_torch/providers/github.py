"""GitHub provider (reference: src/providers/github.rs).

Port of islands_tpu/providers/github.py, a copy: the module is framework-free, but
importing islands_tpu pulls in jax.

REST v3 with `application/vnd.github+json` + API-version header
(github.rs:179-214); webhooks identified by `x-github-event` and verified
with HMAC-SHA256 `sha256=` signatures in constant time (github.rs:121-155).
"""

from __future__ import annotations

from typing import Iterator

from islands_tpu_torch.providers.base import (
    ci_header as _ci_get,
    GitProvider,
    ProviderConfig,
    Repository,
    WebhookEvent,
    WebhookParseError,
    verify_hmac_signature,
)

import json

DEFAULT_BASE_URL = "https://api.github.com"
API_VERSION = "2022-11-28"


class GitHubProvider(GitProvider):
    def __init__(self, config: ProviderConfig | None = None):
        super().__init__(config)

    @property
    def provider_name(self) -> str:
        return "github"

    @property
    def base_url(self) -> str:
        return self.config.base_url or DEFAULT_BASE_URL

    def build_auth_headers(self) -> dict[str, str]:
        """(reference: github.rs:179-214)"""
        headers = {
            "Accept": "application/vnd.github+json",
            "X-GitHub-Api-Version": API_VERSION,
        }
        auth = self.config.auth
        if auth and auth.token:
            headers["Authorization"] = f"Bearer {auth.token}"
        elif auth and auth.username and auth.password:
            import base64

            cred = base64.b64encode(
                f"{auth.username}:{auth.password}".encode()
            ).decode()
            headers["Authorization"] = f"Basic {cred}"
        return headers

    # -- webhooks (reference: github.rs:121-155, :316+) --------------------

    def verify_webhook(self, headers: dict[str, str], body: bytes, secret: str) -> bool:
        sig = _ci_get(headers, "x-hub-signature-256") or ""
        return verify_hmac_signature(secret, body, sig, prefix="sha256=")

    def parse_webhook(self, headers: dict[str, str], body: bytes) -> WebhookEvent:
        event_type = _ci_get(headers, "x-github-event")
        if not event_type:
            raise WebhookParseError("missing x-github-event header")
        try:
            payload = json.loads(body)
        except json.JSONDecodeError as e:
            raise WebhookParseError(f"invalid JSON payload: {e}") from e
        repo_raw = payload.get("repository") or {}
        full = repo_raw.get("full_name", "/")
        owner, _, name = full.partition("/")
        repo = Repository.new(
            "github", owner or "unknown", name or "unknown",
            repo_raw.get("clone_url", f"https://github.com/{full}.git"),
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

    # -- REST API (network; reference: github.rs:216-314) ------------------

    def get_repository(self, owner: str, name: str) -> Repository:
        raw = self.get(f"/repos/{owner}/{name}")
        return self._repo_from_api(raw)

    def list_repositories(self, owner: str) -> Iterator[Repository]:
        """Paginated stream (reference: github.rs:216-281)."""
        page = 1
        while True:
            raws = self.get(f"/users/{owner}/repos?per_page=100&page={page}")
            if not raws:
                return
            for raw in raws:
                yield self._repo_from_api(raw)
            page += 1

    def get_latest_commit(self, owner: str, name: str, branch: str) -> str:
        raw = self.get(f"/repos/{owner}/{name}/commits/{branch}")
        return raw["sha"]

    @staticmethod
    def _repo_from_api(raw: dict) -> Repository:
        owner = (raw.get("owner") or {}).get("login", "")
        return Repository(
            provider="github",
            owner=owner,
            name=raw.get("name", ""),
            clone_url=raw.get("clone_url", ""),
            ssh_url=raw.get("ssh_url"),
            default_branch=raw.get("default_branch", "main"),
            description=raw.get("description"),
            language=raw.get("language"),
            size_kb=raw.get("size", 0),
            last_updated=raw.get("updated_at"),
            is_private=raw.get("private", False),
            topics=raw.get("topics", []),
        )
