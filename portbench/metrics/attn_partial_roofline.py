"""attn_partial_roofline (%): the paged decode attention kernel's share
of its bound over the traced stretch: for each traced decode step and
layer whose attention reads the paged KV (the architecture's
``attention_layers``), the bound of the live (row, key) pairs (the
larger of their operations over the bf16 peak and the live keys' k and
v, q and o, each moved once, over the memory bandwidth), summed, over
the device time of ``fused_attention_partial``'s kernels.  Moves
``out_tok_s``."""
from portbench.harness import cost

KERNELS = ("attn_partial_kernel", "attn_merge_kernel")


def read(run):
    m, t = run.model, run.trace
    if t is None:
        return None
    layers = run.cell.arch.attention_layers(m)
    bound = 0.0
    for s in run.traced_steps:
        if s.decode_keys:
            flops, nbytes = cost.attn_decode_launch(m, s.decode_keys)
            bound += layers * cost.bound_s(flops, nbytes, m["dtype"])
    secs = t.seconds(KERNELS)
    return 100.0 * bound / secs if bound and secs else None
