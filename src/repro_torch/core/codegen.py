"""Schedule → kernel parameters (the paper's §V code-generation role).

A tuned `Schedule` from core.search maps onto one of the kernel
families in repro_torch.kernels; this module extracts the call
parameters (for attention: the CUDA kernel's (bq, bkv) tiles).
"""
from __future__ import annotations

from dataclasses import dataclass

from .dag import Schedule


@dataclass(frozen=True)
class GemmChainParams:
    style: str   # "flat" (sub-expr n(k,h)) | "deep" (sub-expr nk)
    bm: int
    bn: int
    bk: int
    bh: int

    def as_kwargs(self) -> dict:
        return dict(style=self.style, bm=self.bm, bn=self.bn,
                    bk=self.bk, bh=self.bh)


@dataclass(frozen=True)
class AttentionParams:
    bq: int
    bkv: int

    def as_kwargs(self) -> dict:
        return dict(bq=self.bq, bkv=self.bkv)


def schedule_style(sched: Schedule) -> str:
    sub = sched.sub_expr()
    if "(" in sub:
        return "flat"
    if sched.cached_intermediates:
        return "materialize"  # kn class: full intermediate cached
    return "deep"


def to_gemm_chain_params(sched: Schedule) -> GemmChainParams:
    ts = sched.tile_sizes
    style = schedule_style(sched)
    if style == "materialize":
        raise NotImplementedError(
            "kn-class schedules are Rule-2 pruned; no kernel emitted")
    return GemmChainParams(style=style, bm=ts["m"], bn=ts["n"],
                           bk=ts["k"], bh=ts["h"])


def to_attention_params(sched: Schedule) -> AttentionParams:
    ts = sched.tile_sizes
    return AttentionParams(bq=ts["m"], bkv=ts["n"])


# Chain-kind registry: the persistent schedule cache (core.schedule_cache
# via core.api) re-derives params from a rebuilt Schedule and
# cross-checks them against the stored kwargs, so a cache entry can
# never dispatch a kernel this extractor would not emit.
PARAMS_BY_KIND = {
    "gemm": to_gemm_chain_params,
    "attn": to_attention_params,
    # chain.mlp_chain shares the gemm-chain loop structure (m,n,k,h), so
    # the tuned schedule maps onto kernels.gemm_chain.fused_mlp_chain
    # through the same extractor.
    "mlp": to_gemm_chain_params,
}


def params_for(kind: str, sched: Schedule):
    try:
        extract = PARAMS_BY_KIND[kind]
    except KeyError:
        raise ValueError(f"unknown chain kind {kind!r}") from None
    return extract(sched)
