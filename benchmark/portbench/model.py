"""What the benchmark works out from its own plain copy of a network, on
PyTorch's ``meta`` device (shapes only, nothing computed): the seeded
weights' template, the model FLOPs of a forward, and the calls a forward
makes to the layers a kernel metric covers, with their shapes.

Counting on the plain copy gives the same work whatever implements it, so
the numbers do not move when the program routes a layer elsewhere.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from reference import nets


def meta_network(config: dict) -> nn.Module:
    """The configuration's reference network on the meta device."""
    ref = config["reference"]
    with torch.device("meta"):
        return nets.build(ref["network"], **ref["kwargs"])


def count_flops(config: dict, shape: Sequence[int], with_deep: bool) -> float:
    """Model FLOPs of one forward at input ``shape`` (NCDHW): convolutions
    and matrix products, two a multiply-add, as ``FlopCounterMode`` counts."""
    model = meta_network(config)
    x = torch.empty(tuple(shape), device="meta")
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            model(x, with_deep=with_deep)
    return float(counter.get_total_flops())


def module_calls(config: dict, shape: Sequence[int], with_deep: bool,
                 select: Callable[[nn.Module], bool]) -> List[Tuple[nn.Module, Tuple[int, ...],
                                                                   Tuple[int, ...]]]:
    """(module, input shape, output shape) of every call a forward at input
    ``shape`` makes to a module that ``select`` keeps, in call order."""
    model = meta_network(config)
    calls = []

    def hook(module, inputs, output):
        calls.append((module, tuple(inputs[0].shape), tuple(output.shape)))

    handles = [m.register_forward_hook(hook) for m in model.modules() if select(m)]
    try:
        with torch.no_grad():
            model(torch.empty(tuple(shape), device="meta"), with_deep=with_deep)
    finally:
        for h in handles:
            h.remove()
    return calls
