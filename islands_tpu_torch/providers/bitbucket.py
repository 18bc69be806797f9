"""Bitbucket Cloud provider (reference: src/providers/bitbucket.rs).

Port of islands_tpu/providers/bitbucket.py, a copy: the module is framework-free, but
importing islands_tpu pulls in jax.

Bitbucket Cloud API 2.0; webhooks identified by `x-event-key` (e.g.
"repo:push") and verified with `x-hub-signature` HMAC-SHA256
(bitbucket.rs:183,455-468).
"""

from __future__ import annotations

import json
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

DEFAULT_BASE_URL = "https://api.bitbucket.org/2.0"


class BitbucketProvider(GitProvider):
    @property
    def provider_name(self) -> str:
        return "bitbucket"

    @property
    def base_url(self) -> str:
        return self.config.base_url or DEFAULT_BASE_URL

    def build_auth_headers(self) -> dict[str, str]:
        auth = self.config.auth
        if auth and auth.username and auth.password:
            import base64

            cred = base64.b64encode(f"{auth.username}:{auth.password}".encode()).decode()
            return {"Authorization": f"Basic {cred}"}
        if auth and auth.token:
            return {"Authorization": f"Bearer {auth.token}"}
        return {}

    def verify_webhook(self, headers: dict[str, str], body: bytes, secret: str) -> bool:
        sig = _ci_get(headers, "x-hub-signature") or ""
        return verify_hmac_signature(secret, body, sig, prefix="sha256=")

    def parse_webhook(self, headers: dict[str, str], body: bytes) -> WebhookEvent:
        event_key = _ci_get(headers, "x-event-key")
        if not event_key:
            raise WebhookParseError("missing x-event-key header")
        try:
            payload = json.loads(body)
        except json.JSONDecodeError as e:
            raise WebhookParseError(f"invalid JSON payload: {e}") from e
        # "repo:push" -> "push"
        event_type = event_key.split(":", 1)[-1]
        repo_raw = payload.get("repository") or {}
        full = repo_raw.get("full_name", "/")
        owner, _, name = full.partition("/")
        repo = Repository.new(
            "bitbucket", owner or "unknown", name or "unknown",
            f"https://bitbucket.org/{full}.git",
        )
        push = payload.get("push") or {}
        changes = push.get("changes") or [{}]
        new = (changes[0] or {}).get("new") or {}
        return WebhookEvent(
            event_type=event_type,
            repository=repo,
            ref_name=new.get("name"),
            after=((new.get("target") or {}).get("hash")),
            payload=payload,
        )

    def get_repository(self, owner: str, name: str) -> Repository:
        return self._repo_from_api(self.get(f"/repositories/{owner}/{name}"))

    def list_repositories(self, owner: str) -> Iterator[Repository]:
        url = f"/repositories/{owner}?pagelen=100"
        while url:
            raw = self.get(url)
            for item in raw.get("values", []):
                yield self._repo_from_api(item)
            url = raw.get("next")

    def get_latest_commit(self, owner: str, name: str, branch: str) -> str:
        raw = self.get(f"/repositories/{owner}/{name}/refs/branches/{branch}")
        return raw["target"]["hash"]

    @staticmethod
    def _repo_from_api(raw: dict) -> Repository:
        full = raw.get("full_name", "/")
        owner, _, name = full.partition("/")
        clone_url = ""
        ssh_url = None
        for link in (raw.get("links") or {}).get("clone", []):
            if link.get("name") == "https":
                clone_url = link.get("href", "")
            elif link.get("name") == "ssh":
                ssh_url = link.get("href")
        return Repository(
            provider="bitbucket",
            owner=owner,
            name=name,
            clone_url=clone_url or f"https://bitbucket.org/{full}.git",
            ssh_url=ssh_url,
            default_branch=((raw.get("mainbranch") or {}).get("name", "main")),
            description=raw.get("description"),
            is_private=raw.get("is_private", False),
        )
