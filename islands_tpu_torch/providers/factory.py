"""Provider factory (reference: src/providers/factory.rs).

Port of islands_tpu/providers/factory.py, a copy: the module is framework-free, but
importing islands_tpu pulls in jax.

`ProviderType` parsing with default base URLs (:12-60), host-substring
provider detection (:150-180), `create_provider` convenience (:219-244), and
`parse_repo_url` returning (type, owner, name, base_url) (:253-260).
"""

from __future__ import annotations

import enum

from islands_tpu_torch.providers.base import (
    ConfigurationError,
    GitProvider,
    ProviderAuth,
    ProviderConfig,
    Repository,
)
from islands_tpu_torch.providers.bitbucket import BitbucketProvider
from islands_tpu_torch.providers.gitea import GiteaProvider
from islands_tpu_torch.providers.github import GitHubProvider
from islands_tpu_torch.providers.gitlab import GitLabProvider


class ProviderType(str, enum.Enum):
    GITHUB = "github"
    GITLAB = "gitlab"
    BITBUCKET = "bitbucket"
    GITEA = "gitea"

    @staticmethod
    def parse(s: str) -> "ProviderType":
        try:
            return ProviderType(s.lower())
        except ValueError:
            raise ConfigurationError(f"unsupported provider: {s}") from None

    @property
    def default_base_url(self) -> str | None:
        return {
            ProviderType.GITHUB: "https://api.github.com",
            ProviderType.GITLAB: "https://gitlab.com/api/v4",
            ProviderType.BITBUCKET: "https://api.bitbucket.org/2.0",
            ProviderType.GITEA: None,  # self-hosted: must be provided
        }[self]


_PROVIDER_CLASSES = {
    ProviderType.GITHUB: GitHubProvider,
    ProviderType.GITLAB: GitLabProvider,
    ProviderType.BITBUCKET: BitbucketProvider,
    ProviderType.GITEA: GiteaProvider,
}


def detect_provider(url: str) -> ProviderType:
    """Host-substring detection (reference: factory.rs:150-180)."""
    lower = url.lower()
    if "github" in lower:
        return ProviderType.GITHUB
    if "gitlab" in lower:
        return ProviderType.GITLAB
    if "bitbucket" in lower:
        return ProviderType.BITBUCKET
    if "gitea" in lower or "gogs" in lower:
        return ProviderType.GITEA
    raise ConfigurationError(f"cannot detect provider from url: {url}")


class ProviderFactory:
    @staticmethod
    def create(
        provider_type: ProviderType | str,
        auth: ProviderAuth | None = None,
        base_url: str | None = None,
    ) -> GitProvider:
        pt = (
            provider_type
            if isinstance(provider_type, ProviderType)
            else ProviderType.parse(provider_type)
        )
        config = ProviderConfig(base_url=base_url or pt.default_base_url, auth=auth)
        return _PROVIDER_CLASSES[pt](config)

    @staticmethod
    def from_url(url: str, auth: ProviderAuth | None = None) -> GitProvider:
        return ProviderFactory.create(detect_provider(url), auth=auth)


def create_provider(
    provider_type: str,
    token: str | None = None,
    base_url: str | None = None,
) -> GitProvider:
    """Convenience constructor (reference: create_provider, factory.rs:219-244)."""
    auth = ProviderAuth.from_token(token) if token else None
    return ProviderFactory.create(provider_type, auth=auth, base_url=base_url)


def parse_repo_url(url: str) -> tuple[ProviderType, str, str, str | None]:
    """(provider_type, owner, name, base_url) from any supported URL form
    (reference: parse_repo_url, factory.rs:253-260)."""
    repo = Repository.from_url(url)
    pt = ProviderType.parse(repo.provider)
    return pt, repo.owner, repo.name, pt.default_base_url
