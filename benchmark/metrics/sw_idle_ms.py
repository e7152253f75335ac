"""sw_idle_ms.<serve_sw>: the card's idle time whose innermost main-thread
program span is a sliding-window (``sw.*``: the predictor calls and the
stitching) or Swin encoder (``swin.*``) one, over the window's cases (the
program's ``eval.case`` spans), in ms a case: how long the host's enqueue
of the windows' forwards keeps the card waiting. A program without those
spans gives nothing."""

import json

from portbench import program_spans as ps

PREFIXES = ("sw.", "swin.")


def read(ctx, name):
    spans = ps.window_spans(ctx)
    if ctx.trace is None or not spans:
        return None
    n = ps.cases(spans)
    if not n or not any(ps.named(spans, p) for p in PREFIXES):
        return None
    pieces = ps.idle_pieces(ctx.trace, spans)
    ctx.run.note("idle by innermost program span (s): " + json.dumps(ps.idle_by_name(pieces)))
    return sum(b - a for a, b, span in pieces if span.startswith(PREFIXES)) / 1e6 / n
