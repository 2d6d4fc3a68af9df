"""prefill_mfu (%): the prompts the window prefilled, as a share of the
card's bf16 peak: their operations (real tokens; causal attention over
live pairs; the last token's logits), over the wall of the steps that
admitted them less one decode step each (``step.decode_ms``).  Moves
``ttft_p50_ms``."""
from portbench.harness import cost, measure


def read(run):
    adm = [s for s in run.steps if s.prefills]
    dec = measure.decode_step_ms(run)
    if not adm or dec is None:
        return None
    secs = sum((s.t1 - s.t0) - dec * 1e-3 for s in adm)
    flops = sum(run.cell.arch.prefill_flops(run.model, n)
                for s in adm for n in s.prefills)
    if secs <= 0:
        return None
    return 100.0 * flops / secs / cost.peak_flops(run.model["dtype"])
