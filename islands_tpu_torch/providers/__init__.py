"""Git providers: GitHub, GitLab, Bitbucket, Gitea (reference:
src/providers/). Port of islands_tpu/providers, with the same exports.

Host-side plumbing (auth, repository model, webhook verification, rate
limiting, REST clients).
"""

from islands_tpu_torch.providers.base import (
    ApiError,
    AuthenticationError,
    AuthType,
    ConfigurationError,
    GitProvider,
    InvalidWebhookSignature,
    ProviderAuth,
    ProviderConfig,
    ProviderError,
    RateLimiter,
    RateLimitExceeded,
    Repository,
    RepositoryNotFound,
    WebhookEvent,
    WebhookParseError,
    verify_hmac_signature,
)
from islands_tpu_torch.providers.bitbucket import BitbucketProvider
from islands_tpu_torch.providers.factory import (
    ProviderFactory,
    ProviderType,
    create_provider,
    detect_provider,
    parse_repo_url,
)
from islands_tpu_torch.providers.gitea import GiteaProvider
from islands_tpu_torch.providers.github import GitHubProvider
from islands_tpu_torch.providers.gitlab import GitLabProvider

__all__ = [
    "ApiError", "AuthType", "AuthenticationError", "BitbucketProvider",
    "ConfigurationError", "GitHubProvider", "GitLabProvider", "GitProvider",
    "GiteaProvider", "InvalidWebhookSignature", "ProviderAuth",
    "ProviderConfig", "ProviderError", "ProviderFactory", "ProviderType",
    "RateLimitExceeded", "RateLimiter", "Repository", "RepositoryNotFound",
    "WebhookEvent", "WebhookParseError", "create_provider", "detect_provider",
    "parse_repo_url", "verify_hmac_signature",
]
