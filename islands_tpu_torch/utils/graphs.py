"""CUDA graph capture, and a bounded cache of captured graphs.

`capture_cuda_graph` warms a step up and captures it as one CUDA graph;
`GraphCache` keeps the graphs of a few shapes, least recently used out
first. The search's hops (core/search, `HOP_GRAPHS_KEPT` a searcher or
index) and the padded BERT encode (models/bert.encode) use both. A cache
takes its `capture(run, device) -> (replay, out)` as an argument, so the
CPU tests can hand it one that runs the step again instead
(tests/torch_graph_capture.EagerCapture).
"""

from __future__ import annotations

import collections
import threading

import torch

#: Missing keys a cache remembers having been asked for (`GraphCache.after`).
_ASKED_KEPT = 64


def capture_cuda_graph(run, device: torch.device, pool=None):
    """Warm `run` up once on a side stream (as torch.cuda.graphs asks), then
    capture it as one CUDA graph on `device`, its memory from `pool` (a
    `torch.cuda.graph_pool_handle()` that graphs replayed one at a time may
    share; None: a pool of its own). -> (replay, what `run` returned: a
    tensor or a tuple of them, which every replay rewrites in place)."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: a capture must not fail other threads' work.
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            out = run()

    def replay():
        with torch.cuda.device(device):
            graph.replay()

    return replay, out


class GraphCache:
    """Captured graphs by key, at most `kept` of them, least recently used
    out first. `capture(run, device) -> (replay, out)` makes a graph; a key
    is captured on its `after`-th ask, so with `after` = 2 a shape asked
    for once is never captured. `lock` (re-entrant) guards the entries; a
    caller whose graphs share buffers or a pool holds it across a replay
    too."""

    def __init__(self, capture=capture_cuda_graph, kept: int = 4, after: int = 1):
        self.capture = capture
        self.kept = kept
        self.after = after
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._asked: collections.OrderedDict = collections.OrderedDict()
        self.lock = threading.RLock()

    def get(self, key, make):
        """The entry under `key`, made by `make()` (a capture) on the
        `after`-th ask of a missing key; None on the asks before it."""
        with self.lock:
            graph = self._graphs.get(key)
            if graph is not None:
                self._graphs.move_to_end(key)
                return graph
            asked = self._asked.pop(key, 0) + 1
            if asked < self.after:
                self._asked[key] = asked
                while len(self._asked) > _ASKED_KEPT:
                    self._asked.popitem(last=False)
                return None
            graph = self._graphs[key] = make()
            while len(self._graphs) > self.kept:
                self._graphs.popitem(last=False)
            return graph
