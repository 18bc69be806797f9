"""GitLab provider (reference: src/providers/gitlab.rs).

Port of islands_tpu/providers/gitlab.py, a copy: the module is framework-free, but
importing islands_tpu pulls in jax.

API v4; webhooks identified by `x-gitlab-event` and verified by plaintext
`x-gitlab-token` equality (gitlab.rs:143,305-320 — GitLab sends the shared
secret itself, not an HMAC).
"""

from __future__ import annotations

import hmac
import json
import urllib.parse
from typing import Iterator

from islands_tpu_torch.providers.base import (
    ci_header as _ci_get,
    GitProvider,
    ProviderConfig,
    Repository,
    WebhookEvent,
    WebhookParseError,
)

DEFAULT_BASE_URL = "https://gitlab.com/api/v4"


class GitLabProvider(GitProvider):
    @property
    def provider_name(self) -> str:
        return "gitlab"

    @property
    def base_url(self) -> str:
        return self.config.base_url or DEFAULT_BASE_URL

    def build_auth_headers(self) -> dict[str, str]:
        auth = self.config.auth
        if auth and auth.token:
            return {"PRIVATE-TOKEN": auth.token}
        return {}

    def verify_webhook(self, headers: dict[str, str], body: bytes, secret: str) -> bool:
        token = _ci_get(headers, "x-gitlab-token") or ""
        return hmac.compare_digest(token, secret)

    def parse_webhook(self, headers: dict[str, str], body: bytes) -> WebhookEvent:
        event_raw = _ci_get(headers, "x-gitlab-event")
        if not event_raw:
            raise WebhookParseError("missing x-gitlab-event header")
        try:
            payload = json.loads(body)
        except json.JSONDecodeError as e:
            raise WebhookParseError(f"invalid JSON payload: {e}") from e
        # "Push Hook" -> "push"
        event_type = event_raw.lower().removesuffix(" hook").strip() or "unknown"
        proj = payload.get("project") or {}
        full = proj.get("path_with_namespace", "/")
        owner, _, name = full.partition("/")
        repo = Repository.new(
            "gitlab", owner or "unknown", name or "unknown",
            proj.get("git_http_url", f"https://gitlab.com/{full}.git"),
        )
        repo.default_branch = proj.get("default_branch", "main")
        return WebhookEvent(
            event_type=event_type,
            repository=repo,
            ref_name=payload.get("ref"),
            before=payload.get("before"),
            after=payload.get("after"),
            payload=payload,
        )

    def get_repository(self, owner: str, name: str) -> Repository:
        pid = urllib.parse.quote(f"{owner}/{name}", safe="")
        return self._repo_from_api(self.get(f"/projects/{pid}"))

    def list_repositories(self, owner: str) -> Iterator[Repository]:
        page = 1
        while True:
            raws = self.get(f"/users/{owner}/projects?per_page=100&page={page}")
            if not raws:
                return
            for raw in raws:
                yield self._repo_from_api(raw)
            page += 1

    def get_latest_commit(self, owner: str, name: str, branch: str) -> str:
        pid = urllib.parse.quote(f"{owner}/{name}", safe="")
        raw = self.get(f"/projects/{pid}/repository/commits/{branch}")
        return raw["id"]

    @staticmethod
    def _repo_from_api(raw: dict) -> Repository:
        full = raw.get("path_with_namespace", "/")
        # rpartition: subgroup namespaces keep their full path as the owner
        owner, _, name = full.rpartition("/")
        return Repository(
            provider="gitlab",
            owner=owner,
            name=name,
            clone_url=raw.get("http_url_to_repo", ""),
            ssh_url=raw.get("ssh_url_to_repo"),
            default_branch=raw.get("default_branch", "main"),
            description=raw.get("description"),
            is_private=raw.get("visibility") == "private",
            topics=raw.get("topics", []),
        )
