"""ttft.p95_ms (ms): the tail of time to first token over every request
due in the window (``harness.measure.ttfts``), recorded beside the
end-to-end median: of the ~36 requests a 51 s window holds at 0.8 of
the sustained rate it is the second longest wait, and it swings with
the order of arrivals (PERF.md), so it carries no bound.  Moves ``ttft_p50_ms``."""
from portbench.harness import measure


def read(run):
    return measure.ttft_p95_ms(run)
