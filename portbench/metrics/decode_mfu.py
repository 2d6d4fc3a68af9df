"""decode_mfu (%): the decode step's share of the card's bf16 peak: the
operations of every token decoded by the window's steps that admitted
nothing (each at its own context; causal attention over live keys; its
logits), over those steps' host walls.  The whole step beside
``mlp_chain_roofline``, whose time is mostly the decode tile.  Moves
``chat_itl_p50_ms``."""
from portbench.harness import cost


def read(run):
    m = run.model
    steps = [s for s in run.steps if not s.prefills and s.decode_keys]
    secs = sum(s.t1 - s.t0 for s in steps)
    if not secs:
        return None
    flops = sum(run.cell.arch.decode_flops(m, k)
                for s in steps for k in s.decode_keys)
    return 100.0 * flops / secs / cost.peak_flops(m["dtype"])
