"""A whole run on the CPU, without the harness's look for a card, with the
timed path broken underneath: `correct` has to come out false. The tiny
cells keep their knobs and take tight limits; a sound run passes them."""

import pytest
import torch

from benchmark.harness import runner
from benchmark.tests import tiny
from islands_tpu_torch.core import search as search_mod
from islands_tpu_torch.core.leann import LeannIndex
from islands_tpu_torch.core.search import StoredSearcher
from islands_tpu_torch.models.bert import BertModel

CELLS = ["sift-tiny.batch", "code-tiny.batch"]


def entry(name):
    return StoredSearcher if name.startswith("sift") else LeannIndex


def run(tmp_path, name):
    return runner.run_cell(tiny.cell(tmp_path, name), seed=2**31 + 11, seconds=0.3,
                           traced=False, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tmp_path, name):
    out = run(tmp_path, name)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


def _state_unchanged(cond, body, state, max_iters, static_iters):
    return state


def _half_batch(inner):
    def search(self, queries, *args, **kwargs):
        d, ids = inner(self, queries[: queries.shape[0] // 2], *args, **kwargs)
        return d, ids
    return search


def _hidden_altered(inner):
    """The encoder's last hidden states with the first row's first token
    moved, as a wrong value written where the encoder produces it."""
    def forward(self, input_ids, attention_mask):
        h = inner(self, input_ids, attention_mask).clone()
        h[0, 0] += 0.5 * h[0, 0].abs().mean()
        return h
    return forward


def _answer_altered(inner):
    """Each query's first answer id moved to its neighbour in the table."""
    def search(self, queries, *args, **kwargs):
        d, ids = inner(self, queries, *args, **kwargs)
        ids = ids.clone()
        ids[:, 0] = torch.where(ids[:, 0] > 0, ids[:, 0] - 1, ids[:, 0] + 1)
        return d, ids
    return search


def _answers_swapped(inner):
    """The batch's first query given the second's answers."""
    def search(self, queries, *args, **kwargs):
        d, ids = inner(self, queries, *args, **kwargs)
        d, ids = d.clone(), ids.clone()
        d[0], ids[0] = d[1], ids[1]
        return d, ids
    return search


FAULTS = ([(name, f) for name in CELLS for f in ("state unchanged", "half the batch",
                                                 "answer altered", "answers swapped")]
          + [("code-tiny.batch", "encoder output altered")])


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, name, fault):
    """Each fault the cell can have: a step that returns its state
    unchanged, half the batch left out, an answer altered where the entry
    produces it (or given another query's), and in the recompute cell the
    encoder's output altered where it is produced."""
    cls = entry(name)
    if fault == "state unchanged":
        monkeypatch.setattr(search_mod, "_run_hops", _state_unchanged)
    elif fault == "half the batch":
        monkeypatch.setattr(cls, "search", _half_batch(cls.search))
    elif fault == "answer altered":
        monkeypatch.setattr(cls, "search", _answer_altered(cls.search))
    elif fault == "answers swapped":
        monkeypatch.setattr(cls, "search", _answers_swapped(cls.search))
    else:
        monkeypatch.setattr(BertModel, "forward", _hidden_altered(BertModel.forward))
    out = run(tmp_path, name)
    assert out["correct"] is False, out["checks"]
