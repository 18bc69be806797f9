"""Git providers: the base layer (repository model, auth, webhooks, rate
limiting) that the indexer service needs."""

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

__all__ = [
    "ApiError", "AuthType", "AuthenticationError", "ConfigurationError", "GitProvider",
    "InvalidWebhookSignature", "ProviderAuth", "ProviderConfig", "ProviderError",
    "RateLimitExceeded", "RateLimiter", "Repository", "RepositoryNotFound", "WebhookEvent",
    "WebhookParseError", "verify_hmac_signature",
]
