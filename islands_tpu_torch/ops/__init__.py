"""Distance, merge, sketch and kernel ops of the port.

The ops API of the reference (islands_tpu/ops/__init__.py): `adc_scan`
(kernel K3), `pairwise_l2` and `pairwise_neg_dot` (kernel K4, opt-in) and
the `distance` module. Importing builds nothing: each kernel is compiled at
its first launch.
"""

from islands_tpu_torch.ops import distance
from islands_tpu_torch.ops.adc import adc_scan
from islands_tpu_torch.ops.pairwise import pairwise_l2, pairwise_neg_dot

__all__ = ["adc_scan", "distance", "pairwise_l2", "pairwise_neg_dot"]
