"""serve_mfu (%): the whole step's share of the card's bf16 peak: the
operations of every token the window prefilled and decoded (the
experts a token is routed to, not all of them; causal attention over
live pairs; each served token's logits), over the window's seconds.
Moves ``out_tok_s``."""
from portbench.harness import cost


def read(run):
    m, arch = run.model, run.cell.arch
    flops = sum(arch.prefill_flops(m, n) for s in run.steps
                for n in s.prefills)
    flops += sum(arch.decode_flops(m, k) for s in run.steps
                 for k in s.decode_keys)
    if not flops:
        return None
    return 100.0 * flops / run.seconds / cost.peak_flops(m["dtype"])
