"""prefill.span_mfu (%): the window's prompts as a share of the card's
bf16 peak over the engine's own prefill time: their operations (as
``prefill_mfu``'s), over the host seconds of the engine's
``engine.prefill`` phases (``prefill_s``: padding, page table, the
eager prefill, its first token on the host).  None unless the window's
steps saw as many prompts as the engine prefilled (a preempted
request's recompute is a prefill the step log does not see).  Moves
``ttft_p50_ms``."""
from portbench.harness import cost


def read(run):
    secs = run.stats.get("prefill_s")
    lengths = [n for s in run.steps_all for n in s.prefills]
    if not secs or not lengths or len(lengths) != run.stats["prefills"]:
        return None
    flops = sum(run.cell.arch.prefill_flops(run.model, n) for n in lengths)
    return 100.0 * flops / secs / cost.peak_flops(run.model["dtype"])
