"""Answers as the window gathered them, and the verdict on them.

Every query due in the window has an answer row: k ids and k distances. A
row is bad if it is missing or short, holds an id outside [0, N) or twice,
or a distance that is not finite or not ascending. Bad rows count as
`failed`; the limit on them is 0. Each other number the driver compares
has a limit of its own in the cell's file, and is held to it as
value <= limit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Answers:
    pool_idx: np.ndarray  # [Q] the query's index in the traffic's pool
    dists: np.ndarray  # [Q, k] float32 (NaN where no answer came)
    ids: np.ndarray  # [Q, k] int64 (-1 where no answer came)


def gather(calls, k: int) -> Answers:
    """calls: (pool indices [b], distances, ids) per call, as the program
    returned them on the host. A call that returned another shape than
    [b, k] keeps what fits; the rest stays unanswered."""
    idx, ds, is_ = [], [], []
    for sel, d, i in calls:
        b = len(sel)
        dd = np.full((b, k), np.nan, dtype=np.float32)
        ii = np.full((b, k), -1, dtype=np.int64)
        d, i = np.asarray(d), np.asarray(i)
        if d.ndim == 2 and i.shape == d.shape:
            r, c = min(b, d.shape[0]), min(k, d.shape[1])
            dd[:r, :c] = d[:r, :c]
            ii[:r, :c] = i[:r, :c]
        idx.append(np.asarray(sel, dtype=np.int64))
        ds.append(dd)
        is_.append(ii)
    return Answers(np.concatenate(idx), np.concatenate(ds), np.concatenate(is_))


def bad_rows(a: Answers, n: int) -> np.ndarray:
    """[Q] True where the row is not a well-formed top-k answer."""
    ids, d = a.ids, a.dists
    bad = ((ids < 0) | (ids >= n)).any(axis=1) | ~np.isfinite(d).all(axis=1)
    s = np.sort(ids, axis=1)
    bad |= (s[:, 1:] == s[:, :-1]).any(axis=1)
    with np.errstate(invalid="ignore"):
        bad |= (d[:, 1:] < d[:, :-1]).any(axis=1)
    return bad


def verdict(failed: int, numbers: dict, limits: dict) -> tuple[bool, dict]:
    """`correct` and the numbers beside their limits, `failed` first. A
    limit whose number the run did not produce fails."""
    shown = {"bad_answers": {"value": failed, "limit": 0}}
    ok = failed == 0
    for name, limit in limits.items():
        value = numbers.get(name)
        shown[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and np.isfinite(value) and value <= limit
    return bool(ok), shown
