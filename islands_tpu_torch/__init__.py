"""islands_tpu_torch: the PyTorch/CUDA port of islands_tpu.

It builds and queries the sketch-gated proximity-graph index on an NVIDIA
GPU. Entry points (`core.build.build_index_with_sketch`,
`core.search.StoredSearcher`) run on CUDA unless `device="cpu"` is passed,
and raise without a card. The package imports torch and numpy, never jax
and nothing of islands_tpu.
"""

from islands_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
