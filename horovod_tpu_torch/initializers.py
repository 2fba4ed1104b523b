"""Parameter initializers matching flax's defaults (``flax.linen.initializers``).

The port draws its own weights from an explicit ``torch.Generator``; the
numbers differ from ``jax.random``'s, so tests carry weights across with
:func:`horovod_tpu_torch.convert.from_flax` instead of relying on a seed.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# Standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance_scaling divides by it so the truncated draw keeps the variance.
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal(shape: Sequence[int], fan_in: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``variance_scaling(1.0, "fan_in", "truncated_normal")`` in fp32."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    out = torch.empty(tuple(shape), dtype=torch.float32)
    return torch.nn.init.trunc_normal_(out, mean=0.0, std=std, a=-2.0 * std,
                                       b=2.0 * std, generator=generator)
