"""post_host_reads.serve: the host reads that post-processing makes (the
``reads`` counts of the program's ``post.*`` spans: one ``torch.equal`` a
connected-components sweep, the rare-label replacement's ``int`` and
``bool`` reads), over the window's cases (its ``eval.case`` spans); each
read makes the main thread wait for the card."""

from portbench import program_spans as ps


def read(ctx, name):
    spans = ps.window_spans(ctx)
    if not spans:
        return None
    post, n = ps.named(spans, "post."), ps.cases(spans)
    if not post or not n:
        return None
    return sum(s.counts.get("reads", 0) for s in post) / n
