"""data_wait_ms.serve: the mean of ``Engine.evaluate``'s ``data_time`` over
the window's cases: the main thread waiting on the prep stage."""


def read(ctx, name):
    waits = getattr(ctx, "data_wait_s", None)
    return 1000.0 * sum(waits) / len(waits) if waits else None
