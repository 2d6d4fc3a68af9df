"""mlp_chain_roofline (%): the fused MLP kernel's share of its bound
over the traced stretch: the bound of each launch the traced steps
made (the larger of its operations over the bf16 peak and its bytes,
each read or written once, over the memory bandwidth; real rows only),
summed, over the device time of ``fused_mlp_chain``'s kernels.  Most
of that time is the decode tile (M = 32, every decode step); a prefill
launches the kernel only at the padded lengths whose plan fuses the
MLP.  Moves ``chat_itl_p50_ms``."""
from portbench.harness import cost

KERNELS = ("mlp_mma_kernel", "mlp_f32_kernel", "mlp_merge_kernel")


def read(run):
    m, t = run.model, run.trace
    if t is None:
        return None
    # every decode step and every prefill at a length the warm-up saw
    # fused must have launched the kernel once a layer, or the launches
    # cannot be told apart
    page = run.notes["page_size"]
    want = run.stats["decode_steps"] + sum(
        1 for s in run.steps_all for n in s.prefills
        if -(-n // page) * page in run.fused_prefill)
    if run.launches.get("fused_mlp_chain", 0) != want * m["n_layers"]:
        return None
    bound = 0.0
    for s in run.traced_steps:
        rows = [len(s.decode_keys)] if s.decode_keys else []
        rows += [n for n in s.prefills
                 if -(-n // page) * page in run.fused_prefill]
        for r in rows:
            flops, nbytes = cost.mlp_launch(m, r)
            bound += m["n_layers"] * cost.bound_s(flops, nbytes, m["dtype"])
    secs = t.seconds(KERNELS)
    return 100.0 * bound / secs if bound and secs else None
