"""decode_ms.serve: the mean of the harness's span around each case the
program's loader decodes in the window (NIfTI decode, crop, normalise on
its thread)."""


def read(ctx, name):
    spans = getattr(ctx, "decode_s", None)
    return 1000.0 * sum(spans) / len(spans) if spans else None
