"""Seeded weights, made on the device in one draw.

One ``torch.randn`` over every element of the reference network's
``state_dict`` (a ``torch.Generator`` on the card seeded from ``--seed``),
cut into the leaves and scaled: convolution and linear weights by
1/sqrt(fan in), so activations keep their scale through the depth; norm
scales (EvoNorm's γ and v, GroupNorm's weight) and EvoNorm's running
variance 1 + 0.1·n; biases and EvoNorm's β 0.1·n. Parameters are float32,
as the program keeps them; it casts them to bf16 layer by layer.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

ONE_CENTRED = ("gamma", ".v", "running_var")


def seeded_state_dict(template: Dict[str, torch.Tensor], seed: int,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """Fresh float32 tensors on ``device`` for every key of ``template``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    sizes = [t.numel() for t in template.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for (key, t), leaf in zip(template.items(), flat.split(sizes)):
        leaf = leaf.view(t.shape)
        if t.dim() >= 2 and key.endswith("weight"):
            leaf = leaf * (1.0 / math.sqrt(t[0].numel()))
        elif key.endswith(ONE_CENTRED) or (key.endswith("weight") and t.dim() == 1):
            leaf = leaf * 0.1 + 1.0
        else:
            leaf = leaf * 0.1
        out[key] = leaf.contiguous()
    return out
