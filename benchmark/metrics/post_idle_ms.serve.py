"""post_idle_ms.serve: the card's idle time inside post-processing (the
main thread's innermost program span a ``post.*`` one: the host reads of
connected components and of the rare-label replacement wait for the card
there) over the window's cases (the program's ``eval.case`` spans), in ms
a case. Notes, on every traced run, the window's idle seconds by innermost
program span, where the idle outside them falls (before the main thread's
first span, between its spans, after its last), and how much of the idle
under the harness's ``eval_case`` span program spans cover."""

import json

from portbench import program_spans as ps


def read(ctx, name):
    spans = ps.window_spans(ctx)
    if ctx.trace is None or not spans:
        return None
    pieces = ps.idle_pieces(ctx.trace, spans)
    table = ps.idle_by_name(pieces)
    idle_s = ctx.trace.window_s - ctx.trace.busy_s
    ctx.run.note(f"idle by innermost program span (s; {idle_s:.6f} s idle in the trace, "
                 f"{sum(table.values()):.6f} s in the table): {json.dumps(table)}")
    main = [s for s in spans if s.thread == ps.MAIN]
    if main:
        first, last = min(s.start_ns for s in main), max(s.end_ns for s in main)
        where = {"before the first": 0, "between": 0, "after the last": 0}
        for a, b, span in pieces:
            if span == ps.OUTSIDE:
                key = ("before the first" if b <= first else
                       "after the last" if a >= last else "between")
                where[key] += b - a
        ctx.run.note("idle outside program spans (s), by where it falls against the main "
                     "thread's spans: " + json.dumps({k: v / 1e9 for k, v in where.items()}))
    hooked = [(a, b) for th, n, a, b in ctx.spans.items
              if th == ps.MAIN and n == "eval_case"]
    covered, outside = ps.overlap_s(pieces, hooked)
    if covered + outside > 0:
        ctx.run.note(f"idle under the harness's eval_case span: {covered + outside:.6f} s, "
                     f"{covered:.6f} s of it under program spans "
                     f"({100 * covered / (covered + outside):.2f} %)")
    n = ps.cases(spans)
    if not n or not ps.named(spans, "post."):
        return None
    return sum(b - a for a, b, span in pieces if span.startswith("post.")) / 1e6 / n
