"""Carry islands_tpu state across to the port.

The caller hands over the JAX package's CsrGraph and SketchIndex fields as
numpy arrays (`np.asarray(field)`); these functions build the port's objects
from them, so the port's search can run on the reference's own graph and
sketch.
"""

from __future__ import annotations

import torch

from islands_tpu_torch.core.csr import CsrGraph
from islands_tpu_torch.device import resolve_device, to_device
from islands_tpu_torch.ops.proj import SketchIndex


def graph_from_numpy(neighbors, degrees, levels, entry_point, max_level,
                     device=None) -> CsrGraph:
    dev = resolve_device(device)
    return CsrGraph(
        neighbors=to_device(neighbors, dev, torch.int32),
        degrees=to_device(degrees, dev, torch.int32),
        levels=to_device(levels, dev, torch.int32),
        entry_point=int(entry_point),
        max_level=int(max_level),
    )


def sketch_from_numpy(w, scale, node_sketch, nbr_sketch, device=None) -> SketchIndex:
    dev = resolve_device(device)
    return SketchIndex(
        w=to_device(w, dev, torch.float32),
        scale=to_device(scale, dev, torch.float32),
        node_sketch=to_device(node_sketch, dev, torch.int32),
        nbr_sketch=to_device(nbr_sketch, dev, torch.int32),
    )
