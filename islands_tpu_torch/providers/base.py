"""Git-provider base layer: auth, repository model, webhooks, rate limiting.

A copy of islands_tpu/providers/base.py (reference: src/providers/base.rs —
`AuthType`/`ProviderAuth` (:17-95), `Repository` with URL/shorthand parsing
(:97-270), `WebhookEvent` (:272-298), sliding-window `RateLimiter`
(:300-367), `ProviderConfig` (:369-394), the `GitProvider` trait (:397-469)
and `BaseProvider` HTTP helpers (:471-560)). It is framework-free, but the
port keeps its own copy: importing islands_tpu pulls in jax.

HTTP uses urllib from the standard library; network paths are exercised
only through the pure-logic surface (URL parsing, auth headers, webhook
HMAC).
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import hmac
import json
import threading
import time
import urllib.error
import urllib.request
from abc import ABC, abstractmethod
from pathlib import PurePosixPath
from typing import Any, Iterator


class ProviderError(Exception):
    """Base provider error (reference: src/providers/error.rs:12-73)."""


class AuthenticationError(ProviderError):
    pass


class RateLimitExceeded(ProviderError):
    def __init__(self, retry_after: float | None = None):
        super().__init__(f"rate limit exceeded (retry after {retry_after}s)")
        self.retry_after = retry_after


class RepositoryNotFound(ProviderError):
    pass


class InvalidWebhookSignature(ProviderError):
    pass


class WebhookParseError(ProviderError):
    pass


class ConfigurationError(ProviderError):
    pass


class ApiError(ProviderError):
    def __init__(self, status: int, message: str):
        super().__init__(f"API error {status}: {message}")
        self.status = status
        self.message = message


# ---------------------------------------------------------------------------
# Auth (reference: base.rs:17-95)
# ---------------------------------------------------------------------------


class AuthType(str, enum.Enum):
    TOKEN = "token"
    SSH = "ssh"
    OAUTH = "oauth"
    BASIC = "basic"


@dataclasses.dataclass
class ProviderAuth:
    auth_type: AuthType
    token: str | None = None
    username: str | None = None
    password: str | None = None
    ssh_key_path: str | None = None

    @staticmethod
    def from_token(token: str) -> "ProviderAuth":
        return ProviderAuth(AuthType.TOKEN, token=token)

    @staticmethod
    def from_oauth(token: str) -> "ProviderAuth":
        return ProviderAuth(AuthType.OAUTH, token=token)

    @staticmethod
    def from_basic(username: str, password: str) -> "ProviderAuth":
        return ProviderAuth(AuthType.BASIC, username=username, password=password)

    @staticmethod
    def from_ssh(key_path: str) -> "ProviderAuth":
        return ProviderAuth(AuthType.SSH, ssh_key_path=key_path)


# ---------------------------------------------------------------------------
# Repository (reference: base.rs:97-270)
# ---------------------------------------------------------------------------

_HOST_TO_PROVIDER = {
    "github.com": "github", "www.github.com": "github",
    "gitlab.com": "gitlab", "www.gitlab.com": "gitlab",
    "bitbucket.org": "bitbucket", "www.bitbucket.org": "bitbucket",
}

_KNOWN_PROVIDERS = ("github", "gitlab", "bitbucket", "gitea")


@dataclasses.dataclass
class Repository:
    provider: str
    owner: str
    name: str
    clone_url: str
    ssh_url: str | None = None
    default_branch: str = "main"
    description: str | None = None
    language: str | None = None
    size_kb: int = 0
    last_updated: str | None = None
    is_private: bool = False
    topics: list[str] = dataclasses.field(default_factory=list)

    @property
    def full_name(self) -> str:
        return f"{self.owner}/{self.name}"

    @property
    def id(self) -> str:
        return self.full_name

    def local_path(self) -> PurePosixPath:
        """repos/<provider>/<owner>/<name> scheme (reference: base.rs:262-268,
        manager.rs:46-51)."""
        return PurePosixPath(self.provider) / self.owner / self.name

    @staticmethod
    def new(provider: str, owner: str, name: str, clone_url: str) -> "Repository":
        return Repository(provider=provider, owner=owner, name=name, clone_url=clone_url)

    @staticmethod
    def from_url(url: str) -> "Repository":
        """Parse `provider:owner/repo`, bare `owner/repo`, SSH, or HTTPS URLs
        (reference: base.rs:160-246)."""
        url = url.strip()
        if url.startswith(("https://", "http://")):
            return Repository._parse_https(url)
        if url.startswith("git@") or (":" in url and "/" in url.split(":", 1)[1] and "://" not in url and not url.split(":", 1)[0] in _KNOWN_PROVIDERS):
            return Repository._parse_ssh(url)
        if ":" in url:  # provider shorthand, e.g. github:owner/repo
            provider, rest = url.split(":", 1)
            if provider not in _KNOWN_PROVIDERS:
                raise ConfigurationError(f"unknown provider: {provider}")
            return Repository._from_shorthand(provider, rest)
        if "/" in url:  # bare owner/repo -> github
            return Repository._from_shorthand("github", url)
        raise ConfigurationError(f"cannot parse repository URL: {url}")

    @staticmethod
    def _from_shorthand(provider: str, path: str) -> "Repository":
        owner, name = Repository._split_owner_repo(path)
        host = {"bitbucket": "bitbucket.org"}.get(provider, f"{provider}.com")
        clone_url = f"https://{host}/{owner}/{name}.git"
        return Repository.new(provider, owner, name, clone_url)

    @staticmethod
    def _parse_ssh(url: str) -> "Repository":
        body = url.removeprefix("git@")
        if ":" not in body:
            raise ConfigurationError(f"invalid SSH URL: {url}")
        host, path = body.split(":", 1)
        provider = Repository._host_to_provider(host)
        repo = Repository._from_shorthand(provider, path)
        repo.ssh_url = url
        return repo

    @staticmethod
    def _parse_https(url: str) -> "Repository":
        body = url.removeprefix("https://").removeprefix("http://")
        if "/" not in body:
            raise ConfigurationError(f"invalid URL: {url}")
        host, path = body.split("/", 1)
        provider = Repository._host_to_provider(host)
        owner, name = Repository._split_owner_repo(path)
        repo = Repository.new(provider, owner, name,
                              f"https://{host}/{owner}/{name}.git")
        return repo

    @staticmethod
    def _host_to_provider(host: str) -> str:
        if host in _HOST_TO_PROVIDER:
            return _HOST_TO_PROVIDER[host]
        # Self-hosted instances: detect by substring (gitlab.mycorp.io,
        # git.example.com running gitea/gogs, ...).
        lower = host.lower()
        for needle, provider in (
            ("github", "github"), ("gitlab", "gitlab"),
            ("bitbucket", "bitbucket"), ("gitea", "gitea"), ("gogs", "gitea"),
            ("git.", "gitea"),
        ):
            if needle in lower:
                return provider
        raise ConfigurationError(f"unknown provider for host: {host}")

    @staticmethod
    def _split_owner_repo(path: str) -> tuple[str, str]:
        """owner = full namespace (GitLab subgroups keep their path),
        name = last component."""
        path = path.strip("/").removesuffix(".git")
        parts = [p for p in path.split("/") if p]
        if len(parts) < 2:
            raise ConfigurationError(f"expected owner/repo, got: {path}")
        return "/".join(parts[:-1]), parts[-1]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["full_name"] = self.full_name
        return d

    @staticmethod
    def from_dict(d: dict) -> "Repository":
        d = dict(d)
        d.pop("full_name", None)
        return Repository(**d)


# ---------------------------------------------------------------------------
# Webhook events (reference: base.rs:272-298)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WebhookEvent:
    event_type: str
    repository: Repository
    ref_name: str | None = None
    before: str | None = None
    after: str | None = None
    payload: dict = dataclasses.field(default_factory=dict)

    def is_push(self) -> bool:
        return self.event_type == "push"


def ci_header(headers: dict[str, str], key: str) -> str | None:
    """Case-insensitive header lookup (shared by all providers)."""
    for k, v in headers.items():
        if k.lower() == key:
            return v
    return None


def verify_hmac_signature(
    secret: str, payload: bytes, signature: str, prefix: str = "sha256="
) -> bool:
    """Constant-time HMAC-SHA256 verification (reference: github.rs:121-155)."""
    if not signature.startswith(prefix):
        return False
    expected = hmac.new(secret.encode(), payload, hashlib.sha256).hexdigest()
    return hmac.compare_digest(signature[len(prefix):], expected)


# ---------------------------------------------------------------------------
# Rate limiting (reference: base.rs:300-367)
# ---------------------------------------------------------------------------


class RateLimiter:
    """Sliding-window request counter with blocking wait."""

    def __init__(self, max_requests: int = 5000, window_seconds: float = 3600.0):
        self.max_requests = max_requests
        self.window_seconds = window_seconds
        self._timestamps: list[float] = []
        self._lock = threading.Lock()

    def _evict(self, now: float) -> None:
        cutoff = now - self.window_seconds
        self._timestamps = [t for t in self._timestamps if t > cutoff]

    def try_acquire(self) -> bool:
        with self._lock:
            now = time.monotonic()
            self._evict(now)
            if len(self._timestamps) >= self.max_requests:
                return False
            self._timestamps.append(now)
            return True

    def check_and_wait(self, timeout: float | None = None) -> None:
        """Block until a slot frees (reference: check_and_wait, base.rs:330-355)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.try_acquire():
            with self._lock:
                now = time.monotonic()
                self._evict(now)
                wait = (
                    (self._timestamps[0] + self.window_seconds - now)
                    if self._timestamps else 0.01
                )
            if deadline is not None and time.monotonic() + wait > deadline:
                raise RateLimitExceeded(retry_after=wait)
            time.sleep(min(max(wait, 0.001), 1.0))

    @property
    def remaining(self) -> int:
        with self._lock:
            self._evict(time.monotonic())
            return max(self.max_requests - len(self._timestamps), 0)


@dataclasses.dataclass
class ProviderConfig:
    """(reference: base.rs:369-394; defaults 5000 req / 3600 s)"""

    base_url: str | None = None
    auth: ProviderAuth | None = None
    max_requests: int = 5000
    window_seconds: float = 3600.0
    timeout_seconds: float = 30.0
    user_agent: str = "islands-tpu/0.1"


# ---------------------------------------------------------------------------
# GitProvider ABC + HTTP helpers (reference: base.rs:397-560)
# ---------------------------------------------------------------------------


class GitProvider(ABC):
    """Abstract provider (reference GitProvider trait, base.rs:397-469)."""

    def __init__(self, config: ProviderConfig | None = None):
        self.config = config or ProviderConfig()
        self.rate_limiter = RateLimiter(
            self.config.max_requests, self.config.window_seconds
        )

    # -- abstract surface --------------------------------------------------

    @property
    @abstractmethod
    def provider_name(self) -> str: ...

    @property
    @abstractmethod
    def base_url(self) -> str: ...

    @abstractmethod
    def build_auth_headers(self) -> dict[str, str]: ...

    @abstractmethod
    def parse_webhook(self, headers: dict[str, str], body: bytes) -> WebhookEvent: ...

    @abstractmethod
    def verify_webhook(
        self, headers: dict[str, str], body: bytes, secret: str
    ) -> bool: ...

    @abstractmethod
    def list_repositories(self, owner: str) -> Iterator[Repository]: ...

    @abstractmethod
    def get_repository(self, owner: str, name: str) -> Repository: ...

    # -- default implementations (reference: base.rs:440-469) --------------

    def get_default_branch(self, owner: str, name: str) -> str:
        return self.get_repository(owner, name).default_branch

    def get_clone_url(self, repo: Repository) -> str:
        """Token injection into the HTTPS clone URL (reference: base.rs:452-469;
        gitlab uses the `oauth2:` username prefix)."""
        auth = self.config.auth
        if auth is None or auth.token is None:
            return repo.clone_url
        url = repo.clone_url
        if url.startswith("https://"):
            if self.provider_name == "gitlab":
                cred = f"oauth2:{auth.token}"
            elif self.provider_name == "bitbucket":
                # Bitbucket requires the x-token-auth pseudo-user for
                # access-token clones.
                cred = f"x-token-auth:{auth.token}"
            else:
                cred = auth.token
            return f"https://{cred}@{url.removeprefix('https://')}"
        return url

    # -- HTTP plumbing -----------------------------------------------------

    def request(self, method: str, path: str, body: dict | None = None) -> Any:
        """Rate-limited JSON request (reference: BaseProvider::request,
        base.rs:509-531)."""
        self.rate_limiter.check_and_wait()
        url = path if path.startswith("http") else f"{self.base_url}{path}"
        headers = {
            "User-Agent": self.config.user_agent,
            "Accept": "application/json",
            **self.build_auth_headers(),
        }
        data = json.dumps(body).encode() if body is not None else None
        if data is not None:
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(url, data=data, headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.config.timeout_seconds) as r:
                return json.loads(r.read() or b"null")
        except urllib.error.HTTPError as e:  # pragma: no cover - network
            self._check_response(e.code, e.reason, dict(e.headers))
            raise

    def get(self, path: str) -> Any:
        return self.request("GET", path)

    @staticmethod
    def _check_response(status: int, reason: str, headers: dict) -> None:
        """Status-code mapping (reference: check_response, base.rs:533-560)."""
        if status == 404:
            raise RepositoryNotFound(reason)
        if status in (401, 403):
            raise AuthenticationError(reason)
        if status == 429:
            retry = headers.get("Retry-After")
            raise RateLimitExceeded(retry_after=float(retry) if retry else None)
        if status >= 400:
            raise ApiError(status, str(reason))
