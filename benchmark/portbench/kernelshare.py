"""A kernel's share of its roofline over the traced window: the least
time that the window's calls to it need (operations and bytes from their
shapes, at the chip's peaks) over the device time of the kernels that
did them, found in the trace by name.

The calls are those of the configuration's plain network at the window's
shape, counted on the meta device, times the forwards in the window; the
program's launch counter must agree, or the share is not read (a change
that routes some calls elsewhere needs the kernel wrapper's spans to
attribute them)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

from .model import module_calls
from .roofline import bound


def roofline_share(ctx, kernel_names: Sequence[str], counter: str,
                   select: Callable, work: Callable[[tuple, tuple, dict], Tuple[float, float,
                                                                                float]]
                   ) -> Optional[float]:
    """Percent; ``work(input shape, output shape, config)`` gives
    (operations, peak operations/s, bytes) of one call."""
    if ctx.trace is None:
        return None
    calls = module_calls(ctx.network, ctx.forward_shape, ctx.with_deep, select)
    if not calls:
        return None
    launches = ctx.launches.get(counter, 0)
    if launches != ctx.forwards * len(calls):
        ctx.run.note(f"{counter}: {launches} launches against {ctx.forwards} forwards x "
                     f"{len(calls)} calls: the share is not read")
        return None
    least = 0.0
    for _, inp, out in calls:
        ops, peak, nbytes = work(inp, out, ctx.network)
        least += bound(ops, peak, nbytes)[0]
    seconds = ctx.trace.kernel_seconds(lambda n: any(k in n for k in kernel_names))
    if seconds <= 0:
        return None
    return 100.0 * ctx.forwards * least / seconds
