"""mb_tokens_per_query: tokens the port's packed ModernBERT forward encoded
per query in the window (its always-on counter
`models.modernbert.forward_packed.tokens_encoded`, read by the driver
around each call): the query chunk's and those of every row the provider
re-encoded, invalid slots and rows the gate throws away included."""


def read(run):
    calls = [c for c in run.calls if "tokens_encoded" in c.counts]
    if not calls:
        return None
    return sum(c.counts["tokens_encoded"] for c in calls) / sum(c.queries for c in calls)
