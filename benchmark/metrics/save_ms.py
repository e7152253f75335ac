"""save_ms.serve: the mean of the program's ``finish.save`` spans that
started in the window (on the finish stage's thread: the labels un-padded,
un-cropped and written as NIfTI), in ms."""

from portbench import program_spans as ps


def read(ctx, name):
    spans = ps.window_spans(ctx)
    saves = ps.named(spans or [], "finish.save")
    if not saves:
        return None
    return sum(s.end_ns - s.start_ns for s in saves) / 1e6 / len(saves)
