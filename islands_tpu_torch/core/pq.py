"""Product quantization: k-means training, encoding and ADC tables.

Port of islands_tpu/core/pq.py, batch-major: the reference vmaps each step
over the subquantizer axis; here every k-means array carries that axis first
([S, n, sub_dim] points, [S, k, sub_dim] centroids).

- assignment is an [S, n, k] distance-matrix argmin (one batched matmul);
- the centroid update is a one-hot [S, k, n] x [S, n, sub_dim] matmul, which
  sums in a fixed order (a scatter-add would sum in atomic order and make
  the build differ from run to run);
- k-means++ seeding draws from a `torch.Generator` (`torch.multinomial` in
  place of `jax.random.categorical`), so the same seed gives another
  codebook than the reference's; convert.pq_from_numpy carries the
  reference's across;
- empty clusters are reseeded deterministically to the points farthest from
  their assigned centroid.

Distances: `asymmetric_distance` is sqrt(sum over subspaces of subspace L2^2);
ADC tables hold squared per-subspace distances and `table_distance` is
gather + sum + sqrt. The two-level search uses metric-scale tables
(`_build_metric_tables`) through `gated_block_scorer_for`, whose "grouped"
scorer launches kernel K2; `pq_scan` launches kernel K3.

Codes are uint8 up to 256 centroids. Above that they are int32: torch has
no uint16 indexing, and int32 holds every id up to the 65,536-centroid cap.
K3 takes either; K2 and the inline code blocks of the two-level search take
uint8 only.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from islands_tpu_torch.core.config import PQConfig
from islands_tpu_torch.device import resolve_device, to_device
from islands_tpu_torch.ops import distance as dist_ops
from islands_tpu_torch.ops.adc import (
    adc_scan,
    gated_adc_reference,
    gated_adc_sums,
    rows_table_sums,
)
from islands_tpu_torch.ops.merge import argsort

_INF = float("inf")


class PQError(ValueError):
    """Invalid PQ operation."""


# ---------------------------------------------------------------------------
# k-means, batched over a leading subspace axis
# ---------------------------------------------------------------------------


def _sq_dists(pts: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [..., n, k] = |p|^2 + |c|^2 - 2 p.c, clamped at 0."""
    p2 = torch.sum(pts * pts, dim=-1)[..., :, None]
    c2 = torch.sum(centroids * centroids, dim=-1)[..., None, :]
    cross = pts @ centroids.transpose(-1, -2)
    return torch.clamp(p2 + c2 - 2.0 * cross, min=0.0)


def _kmeans_pp_init(gen: torch.Generator, pts: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding of each subspace: pts [S, n, sd] -> [S, k, sd]. The
    first centroid is uniform, each next one drawn with probability
    proportional to the squared distance to the nearest chosen centroid
    (uniform when all of those are 0, i.e. k > distinct points)."""
    s, n, sd = pts.shape
    rows = torch.arange(s, device=pts.device)
    first = torch.randint(0, n, (s,), generator=gen, device=pts.device)
    centroids = torch.zeros((s, k, sd), dtype=torch.float32, device=pts.device)
    c = pts[rows, first]
    centroids[:, 0] = c
    mind = torch.sum((pts - c[:, None, :]) ** 2, dim=-1)  # [S, n]
    for i in range(1, k):
        w = torch.where(mind.amax(dim=1, keepdim=True) > 0.0, mind,
                        torch.ones_like(mind))
        idx = torch.multinomial(w, 1, generator=gen)[:, 0]
        c = pts[rows, idx]
        centroids[:, i] = c
        mind = torch.minimum(mind, torch.sum((pts - c[:, None, :]) ** 2, dim=-1))
    return centroids


def _lloyd_step(pts: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration with deterministic empty-cluster reseeding:
    pts [S, n, sd], centroids [S, k, sd] -> new centroids [S, k, sd]."""
    s, n, sd = pts.shape
    k = centroids.shape[1]
    d2 = _sq_dists(pts, centroids)  # [S, n, k]
    dmin, assign = torch.min(d2, dim=-1)  # first minimum, as jnp.argmin
    onehot = torch.nn.functional.one_hot(assign, k).to(torch.float32)  # [S, n, k]
    counts = onehot.sum(dim=1)  # [S, k]
    sums = onehot.transpose(1, 2) @ pts  # [S, k, sd]
    new = sums / torch.clamp(counts, min=1.0)[..., None]

    # Empty clusters take the points farthest from their assigned centroid,
    # the i-th empty cluster the i-th farthest point.
    empty = counts == 0.0
    far_order = argsort(-dmin)  # [S, n], farthest first (stable)
    empty_rank = torch.cumsum(empty.to(torch.int64), dim=1) - 1
    cand = far_order.gather(1, torch.clamp(empty_rank, 0, n - 1))  # [S, k]
    reseed = pts.gather(1, cand[:, :, None].expand(s, k, sd))
    return torch.where(empty[..., None], reseed, new)


def kmeans(gen: torch.Generator, pts: torch.Tensor, k: int,
           iterations: int = 25) -> tuple[torch.Tensor, torch.Tensor]:
    """k-means of each subspace: pts [S, n, sd] -> (centroids [S, k, sd],
    assignments [S, n] int32)."""
    pts = pts.float()
    centroids = _kmeans_pp_init(gen, pts, k)
    for _ in range(iterations):
        centroids = _lloyd_step(pts, centroids)
    assign = torch.argmin(_sq_dists(pts, centroids), dim=-1).to(torch.int32)
    return centroids, assign


# ---------------------------------------------------------------------------
# Product quantizer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PQCodebook:
    """Trained codebooks: centroids [num_sq, num_centroids, sub_dim] f32."""

    centroids: torch.Tensor

    @property
    def num_subquantizers(self) -> int:
        return self.centroids.shape[0]

    @property
    def num_centroids(self) -> int:
        return self.centroids.shape[1]

    @property
    def sub_dim(self) -> int:
        return self.centroids.shape[2]

    @property
    def dimension(self) -> int:
        return self.num_subquantizers * self.sub_dim

    def find_nearest(self, sub_vectors: torch.Tensor) -> torch.Tensor:
        """Nearest centroid per subspace: [num_sq, sub_dim] -> [num_sq] int32."""
        d2 = _sq_dists(sub_vectors[:, None, :], self.centroids)  # [S, 1, k]
        return torch.argmin(d2[:, 0, :], dim=-1).to(torch.int32)


def _split_subspaces(x: torch.Tensor, num_sq: int) -> torch.Tensor:
    """[n, d] -> [num_sq, n, sub_dim]."""
    n, d = x.shape
    return x.reshape(n, num_sq, d // num_sq).transpose(0, 1)


def _scan_sums(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """tables [B, S, k], codes [n, S] -> ADC sums [B, n], kernel K3 on the
    card. Codes wider than uint8 go as int32, as the reference casts them."""
    return adc_scan(tables, codes if codes.dtype == torch.uint8 else codes.to(torch.int32))


def _table_distance(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """tables [B, S, k], codes [n, S] -> sqrt(max(sum, 0)) [B, n]."""
    return torch.sqrt(torch.clamp(_scan_sums(tables, codes), min=0.0))


class ProductQuantizer:
    """Product quantizer: `pq = ProductQuantizer(config); pq.train(x);
    codes = pq.encode(x)`. Runs on CUDA unless `device="cpu"`."""

    def __init__(self, config: PQConfig | None = None, device=None):
        self.config = config or PQConfig()
        self.device = resolve_device(device)
        self.codebook: PQCodebook | None = None
        self._dimension: int | None = None

    # -- training ----------------------------------------------------------

    @property
    def is_trained(self) -> bool:
        return self.codebook is not None

    @property
    def dimension(self) -> int | None:
        return self._dimension

    @property
    def code_dtype(self) -> torch.dtype:
        return torch.uint8 if self.config.num_centroids <= 256 else torch.int32

    def train(self, x, max_train_points: int = 131072) -> "ProductQuantizer":
        """Train per-subspace codebooks, all subspaces at once. Above
        `max_train_points` rows a deterministic stride sample is used."""
        x = to_device(x, self.device, torch.float32)
        if x.dim() != 2:
            raise PQError("training data must be [n, d]")
        n, d = x.shape
        cfg = self.config
        cfg.validate(d)
        if n < cfg.num_centroids:
            raise PQError(f"need at least {cfg.num_centroids} training vectors, got {n}")
        if n > max_train_points:
            stride = -(-n // max_train_points)  # ceil: sample the full range
            x = x[::stride][:max_train_points]
        subs = _split_subspaces(x, cfg.num_subquantizers).contiguous()
        seed = cfg.seed if cfg.seed is not None else 0
        gen = torch.Generator(device=self.device).manual_seed(seed)
        centroids, _ = kmeans(gen, subs, cfg.num_centroids, cfg.training_iterations)
        self.codebook = PQCodebook(centroids=centroids)
        self._dimension = d
        return self

    def _require_trained(self) -> PQCodebook:
        if self.codebook is None:
            raise PQError("quantizer is not trained")
        return self.codebook

    # -- encode / decode ---------------------------------------------------

    def encode(self, x, chunk: int = 65536) -> torch.Tensor:
        """[n, d] -> codes [n, num_sq] (nearest centroid per subspace),
        chunked over n to bound the [S, chunk, k] distance matrix."""
        cb = self._require_trained()
        x = to_device(x, self.device, torch.float32)
        if x.dim() == 1:
            return self.encode(x[None, :], chunk)[0]
        if x.shape[1] != self._dimension:
            raise PQError(f"dimension mismatch: expected {self._dimension}, got {x.shape[1]}")
        outs = []
        for s in range(0, x.shape[0], chunk):
            subs = _split_subspaces(x[s:s + chunk], cb.num_subquantizers)
            d2 = _sq_dists(subs, cb.centroids)  # [S, c, k]
            outs.append(torch.argmin(d2, dim=-1).T.to(self.code_dtype))
        if not outs:
            return torch.zeros((0, cb.num_subquantizers), dtype=self.code_dtype,
                               device=self.device)
        return torch.cat(outs) if len(outs) > 1 else outs[0].contiguous()

    def decode(self, codes) -> torch.Tensor:
        """codes [n, num_sq] -> reconstruction [n, d]."""
        cb = self._require_trained()
        codes = to_device(codes, self.device)
        if codes.dim() == 1:
            return self.decode(codes[None, :])[0]
        sq = torch.arange(cb.num_subquantizers, device=self.device)
        g = cb.centroids[sq[None, :], codes.long()]  # [n, S, sd]
        return g.reshape(codes.shape[0], -1)

    # -- distances ---------------------------------------------------------

    def asymmetric_distance(self, q, codes) -> torch.Tensor:
        """sqrt(sum_s |q_s - c_{s,code}|^2): q [d] or [B, d], codes [num_sq]
        or [n, num_sq] -> [B, n] (fewer dims for 1-D inputs)."""
        q = to_device(q, self.device, torch.float32)
        codes = to_device(codes, self.device)
        tables = self.build_distance_tables(q if q.dim() > 1 else q[None])
        d = _table_distance(tables, codes if codes.dim() > 1 else codes[None])
        if q.dim() == 1:
            d = d[0]
        if codes.dim() == 1:
            d = d[..., 0]
        return d

    def build_distance_tables(self, q) -> torch.Tensor:
        """ADC tables: q [B, d] (or [d]) -> squared per-subspace distances
        [B, num_sq, num_centroids]."""
        cb = self._require_trained()
        q = to_device(q, self.device, torch.float32)
        q2 = q if q.dim() > 1 else q[None]
        qs = _split_subspaces(q2, cb.num_subquantizers)
        t = _sq_dists(qs, cb.centroids).transpose(0, 1).contiguous()
        return t if q.dim() > 1 else t[0]

    def table_distance(self, tables, codes) -> torch.Tensor:
        """Gather + sum + sqrt over precomputed tables: tables [B, num_sq, k]
        or [num_sq, k]; codes [n, num_sq] or [num_sq]."""
        t = to_device(tables, self.device, torch.float32)
        c = to_device(codes, self.device)
        d = _table_distance(t[None] if t.dim() == 2 else t, c[None] if c.dim() == 1 else c)
        if t.dim() == 2:
            d = d[0]
        if c.dim() == 1:
            d = d[..., 0]
        return d

    # -- storage -----------------------------------------------------------

    def storage_bytes(self, num_vectors: int) -> int:
        """Code bytes (at the reference's accounting: 1 B per subspace up to
        256 centroids, 2 B above) plus the f32 codebook."""
        cb = self._require_trained()
        return num_vectors * self.config.bytes_per_vector + cb.centroids.numel() * 4


def pq_scan(pq: ProductQuantizer, queries, codes: torch.Tensor, metric=None) -> torch.Tensor:
    """ADC scan of ALL codes: queries [B, d] -> distances [B, n] on the
    exact metric's scale. The sums are kernel K3 on the card."""
    cb = pq._require_trained()
    mname = _metric_name(metric) if metric is not None else "euclidean"
    q2 = to_device(queries, pq.device, torch.float32)
    q2 = q2 if q2.dim() > 1 else q2[None]
    if mname == "cosine":  # tables are inner products; cosine needs |q| = 1
        q2 = dist_ops.normalize(q2)
    tables = _build_metric_tables(q2, cb.centroids, mname)
    return _finalize_adc(_scan_sums(tables, to_device(codes, pq.device)), mname)


def make_pq_scorer(pq: ProductQuantizer, codes: torch.Tensor):
    """Approximate scorer over PQ codes: (prep, scorer) with prep(q [B, d])
    -> tables and scorer(tables, ids [B, E], valid [B, E]) -> [B, E]
    distances (+inf where not valid)."""
    n = codes.shape[0]

    def prep(q):
        return pq.build_distance_tables(q)

    def scorer(tables, ids, valid):
        rows = codes[torch.clamp(ids, 0, n - 1).long()]  # [B, E, S]
        d = torch.sqrt(torch.clamp(rows_table_sums(tables, rows), min=0.0))
        return torch.where(valid, d, _INF)

    return prep, scorer


# ---------------------------------------------------------------------------
# Metric-scale ADC for the two-level (PQ-gated) search
# ---------------------------------------------------------------------------


def _metric_name(metric) -> str:
    return getattr(metric, "value", str(metric))


def _build_metric_tables(q: torch.Tensor, centroids: torch.Tensor,
                         metric_name: str) -> torch.Tensor:
    """ADC tables whose gather + sum (+ finalize) approximates the search
    metric, so approximate and exact distances share one scale:
    - cosine / dotproduct: -<q_s, c_{s,k}>
    - euclidean: |q_s - c_{s,k}|^2
    - manhattan: |q_s - c_{s,k}|_1
    q [B, d] -> [B, S, k]."""
    qs = _split_subspaces(q.float(), centroids.shape[0])  # [S, B, sd]
    if metric_name in ("cosine", "dotproduct"):
        t = -(qs @ centroids.transpose(1, 2))
    elif metric_name == "euclidean":
        t = _sq_dists(qs, centroids)
    elif metric_name == "manhattan":
        # One subspace at a time bounds the [B, k, sd] intermediate.
        t = torch.stack([torch.sum(torch.abs(qs[s][:, None, :] - centroids[s][None]), dim=-1)
                         for s in range(qs.shape[0])])
    else:
        raise ValueError(f"unknown metric: {metric_name}")
    return t.transpose(0, 1).contiguous()


def build_inline_codes(neighbors: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Inline neighbour-code blocks: [N, m0] graph + [n, S] codes -> [N, m0*S]
    uint8, row i = the codes of node i's neighbours, concatenated, so a hop
    gathers one block per expanded node. Sentinel (-1) slots get node 0's
    codes; the hop masks them before scoring.

    The blocks are uint8, so codes of more than 256 centroids raise: the
    reference casts them to uint8, which wraps them to wrong centroids."""
    if codes.dtype != torch.uint8:
        raise PQError("the two-level path takes uint8 codes (at most 256 centroids), "
                      f"got {codes.dtype}")
    safe = torch.clamp(neighbors, 0, max(codes.shape[0] - 1, 0)).long()
    blocks = codes[safe]  # [N, m0, S]
    return blocks.reshape(neighbors.shape[0], -1)


def _finalize_adc(s: torch.Tensor, metric_name: str) -> torch.Tensor:
    """ADC sums -> distances on the exact metric's scale."""
    if metric_name == "cosine":
        return 1.0 + s
    if metric_name == "euclidean":
        return torch.sqrt(torch.clamp(s, min=0.0))
    return s  # dotproduct / manhattan: sums already on the metric scale


def _gated_block_scorer(tables, block_codes, valid, *, metric_name: str, sums):
    return torch.where(valid, _finalize_adc(sums(tables, block_codes), metric_name), _INF)


def gated_block_scorer_for(metric, impl: str = "grouped"):
    """ADC scorer over inline code blocks for the two-level hop:
    scorer(tables [B, S, K], block_codes [B, E, S] uint8, valid [B, E]) ->
    [B, E] distances on the metric's scale, +inf where not valid.

    impl="grouped" launches kernel K2 (ops/adc.gated_adc_sums); "einsum"
    runs its plain version `gated_adc_reference`, the reference's A/B
    baseline. The two give identical distances. The finalize and the mask
    stay outside the kernel."""
    if impl == "grouped":
        sums = gated_adc_sums
    elif impl == "einsum":
        sums = gated_adc_reference
    else:
        raise ValueError(f"adc_impl must be 'grouped' or 'einsum', got {impl!r}")
    return functools.partial(_gated_block_scorer, metric_name=_metric_name(metric), sums=sums)


def gated_prep_for(metric):
    """Table prep `(centroids [S, K, sd], qp [B, d]) -> tables [B, S, K]` for
    the two-level search."""
    return functools.partial(_gated_prep, metric_name=_metric_name(metric))


def _gated_prep(centroids: torch.Tensor, qp: torch.Tensor, *, metric_name: str) -> torch.Tensor:
    return _build_metric_tables(qp, centroids, metric_name)
