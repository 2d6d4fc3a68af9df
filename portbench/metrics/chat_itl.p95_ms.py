"""chat_itl.p95_ms (ms): the 95th percentile of every inter-token gap
in the open-loop cell (``harness.measure.itl_gaps``).  At 0.8 of the
sustained rate about one step in thirteen admits a prompt, so the 95th
gap falls where the gaps turn from decode steps to admitting steps, and
it swings from run to run (PERF.md): it carries no bound.  An admitting
step's wall is a prefill's, so it moves with ``ttft_p50_ms``."""
from portbench.harness import measure


def read(run):
    return measure.itl_p95_ms(run)
