"""case_latency_p90_s: the 90th percentile of the latencies of the cases
handed out in the window, each from the start of its decode to its label
map written. In a closed backlog the queue ahead of each case sets most
of it, so it follows the rate and is no end-to-end metric of its own."""

from portbench.harness import quantile


def read(ctx, name):
    latencies = getattr(ctx, "latencies_s", None)
    return quantile(latencies, 0.9) if latencies else None
