"""Decoder-only LM, dense (qwen3, granite, codeqwen) or mixture of
experts (olmoe, mixtral): the cache-free forward and loss, fixed-batch
decoding over a contiguous KV cache, and paged serving, hand-wired or
run from the fusion planner's plans (``Runtime(planner=True)``, paged
serving of the configs the planner can plan; the others run hand-wired,
as in the JAX package).

The JAX package's ``LM`` scans a stack of stacked layer parameters;
here the layers are a Python list walked by a loop, parameters are
dicts of tensors created directly on the model's device, and execution
is eager (``launch.serve.generate`` and ``serving.engine`` capture a
decode step in a CUDA graph on the card).  Both caches are written IN
PLACE, where the JAX package returns updated copies.  The API:

    init_params(seed)                      -> params on ``device``
    forward(params, tokens)                -> logits (B, S, V)
    loss(params, batch)                    -> scalar mean cross-entropy
                                              (under autograd after
                                              ``requires_grad(params)``)
    init_cache(batch, max_len)             -> per-layer {k, v, pos}
    prefill(params, tokens, cache)         -> (last logits (B, V), cache)
    decode_step(params, cache, tokens, pos)
    init_paged_cache(n_pages, page_size)   -> per-layer page pools
    prefill_paged(params, tokens, cache, page_table, length)
    decode_step_paged(params, cache, tokens, positions, page_table)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import tree as T
from ..core import planner
from . import layers as L
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context threaded through model code."""

    bkv: int = 512          # kv block of the cache-free streaming twin
    kernel_ops: bool = False  # attention through the fused CUDA kernels
    # when the tensors are on the card — the cache-free forward's
    # (kernels.attention.fused_attention, tuned per shape) and paged
    # decode's (fused_attention_paged); the model's twins otherwise.
    paged_block: Optional[tuple] = None  # (bq, bkv) tiles the paged
    # regime search picked — serving.engine threads them so the kernel
    # executes the schedule the tuner priced.
    planner: bool = False   # run every paged-serving block from
    # core.planner's plan for its phase (prefill/decode) — chains carved
    # and glue stitched from the config alone under the H100 descriptor;
    # with kernel_ops, each fused MLP chain runs as the fused_mlp_chain
    # CUDA kernel.  A config the planner cannot plan
    # (core.planner.plannable: MoE) runs hand-wired.  The cache-free
    # forward has no planned path yet.
    stitch: bool = True     # planner mode only: stitch memory-bound
    # glue into carved chains as prologue/epilogue; False is
    # bit-identical to the hand-wired layer.
    sentinels: bool = False  # arm the in-step activation health
    # monitor (reliability/sentinels.py::healthy): the serving engine
    # checks prefill and decode logits for NaN/Inf/explosion and evicts
    # the offending slot with the honest "health" outcome.


def _chunk_len(s: int, target: int = 512) -> int:
    """Largest divisor of s that is <= target."""
    best = 1
    for c in range(1, min(s, target) + 1):
        if s % c == 0:
            best = c
    return best


def chunked_ce(hidden: torch.Tensor, unembed_w: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over sequence chunks of at most 512, so the
    (B, S, V) logits never exist at once.  hidden: (B, S, D) after the
    final norm; unembed_w: (D, V); labels: (B, S), -100 masked.  Each
    chunk's logits are taken in the model's type and reduced in f32
    (logsumexp minus the target logit)."""
    b, s, _ = hidden.shape
    c = _chunk_len(s)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, c):
        lf = (hidden[:, c0:c0 + c] @ unembed_w).float()
        lch = labels[:, c0:c0 + c]
        lse = torch.logsumexp(lf, dim=-1)
        tgt = torch.gather(lf, -1, lch.clamp(min=0)[..., None])[..., 0]
        mask = (lch >= 0).float()
        tot = tot + ((lse - tgt) * mask).sum()
        cnt = cnt + mask.sum()
    return tot / torch.clamp(cnt, min=1.0)


def requires_grad(params: dict) -> dict:
    """Mark every parameter leaf as requiring grad, IN PLACE, so that
    ``LM.loss`` back-propagates into ``.grad`` (the training step's
    counterpart of ``jax.value_and_grad``); returns ``params``.  The
    kernel path stays forward-only: ``Runtime(kernel_ops=True)`` raises
    under grad mode, as the JAX kernels have no gradient."""
    for t in T.leaves(params):
        t.requires_grad_(True)
    return params


class LM:
    def __init__(self, cfg: ModelConfig, rt: Optional[Runtime] = None,
                 device="cuda"):
        if (cfg.family not in ("dense", "moe") or cfg.norm != "rmsnorm"
                or not cfg.use_rope):
            raise NotImplementedError(
                f"the port serves dense and MoE rmsnorm/rope decoders; "
                f"{cfg.name} is {cfg.family} with {cfg.norm} (rope: "
                f"{cfg.use_rope}); the other families: ROADMAP Queue 1 "
                f"item 6")
        self.cfg = cfg
        self.rt = rt or Runtime()
        self.device = torch.device(device)

    # ------------------------------------------------------------------
    def init_params(self, seed: int) -> dict:
        """Seeded random weights made on ``self.device`` (a full-width
        bf16 model is never staged on the host)."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        dt = getattr(torch, cfg.dtype)
        layers = []
        for _ in range(cfg.n_layers):
            layers.append({
                "ln1": {"w": torch.zeros(cfg.d_model, device=dev)},
                "mix": L.init_attention(gen, cfg, dev),
                "ln2": {"w": torch.zeros(cfg.d_model, device=dev)},
                "ff": (L.init_moe(gen, cfg, dev) if cfg.moe
                       else L.init_mlp(gen, cfg, dev)),
            })
        return {
            "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), dt, dev,
                                  scale=0.02),
            "final_norm": {"w": torch.zeros(cfg.d_model, device=dev)},
            "lm_head": L.dense_init(gen, (cfg.d_model, cfg.vocab), dt, dev),
            "layers": layers,
        }

    # ------------------------------------------------------------------
    def _apply_block(self, p: dict, x: torch.Tensor,
                     positions: torch.Tensor,
                     cache: Optional[dict] = None) -> torch.Tensor:
        """One hand-wired block over a contiguous ``cache`` (written in
        place), or cache-free (the forward).  The planner plans only
        cache-free and paged blocks of the configs it can plan, so a
        cached block, and any block of an MoE config, runs hand-wired
        under ``Runtime(planner=True)`` too, as in the JAX package."""
        cfg, rt = self.cfg, self.rt
        if rt.planner and cache is None and planner.plannable(cfg):
            raise NotImplementedError(
                "the planned cache-free forward is not ported; use "
                "Runtime(planner=False)")
        h = L.rmsnorm(x, p["ln1"]["w"], cfg.norm_eps)
        x = x + L.attention_block(p["mix"], h, cfg, positions=positions,
                                  bkv=rt.bkv, kernel_ops=rt.kernel_ops,
                                  cache=cache)
        h2 = L.rmsnorm(x, p["ln2"]["w"], cfg.norm_eps)
        return x + L.feed_forward(p["ff"], h2, cfg)

    def _hidden(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The cache-free stack's output before the final norm."""
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x = self._embed(params, tokens)
        for p in params["layers"]:
            x = self._apply_block(p, x, positions)
        return x

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens]

    def forward(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The cache-free forward: tokens (B, S) -> logits (B, S, V)."""
        return self._unembed(params, self._hidden(params, tokens))

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """batch: {"tokens", "labels"}, labels aligned with tokens (-100 =
        masked).  Mean cross-entropy by ``chunked_ce``: no (B, S, V)
        logits."""
        x = L.rmsnorm(self._hidden(params, batch["tokens"]),
                      params["final_norm"]["w"], self.cfg.norm_eps)
        return chunked_ce(x, params["lm_head"], batch["labels"])

    # ------------------------------------------------------------------
    def _apply_layer(self, p: dict, x: torch.Tensor,
                     positions: torch.Tensor, cache: dict,
                     page_table: torch.Tensor) -> torch.Tensor:
        cfg, rt = self.cfg, self.rt
        if rt.planner and planner.plannable(cfg):
            from ..reliability import breaker as _breaker
            b, s = x.shape[:2]
            ps = cache["k_pages"].shape[2]
            plan_kw = dict(phase="prefill" if s > 1 else "decode",
                           paged=ps, kv_len=page_table.shape[1] * ps)
            pkey = planner.plan_key(cfg, b, s, rt.stitch, **plan_kw)
            # A quarantined plan fingerprint (circuit breaker) serves
            # the hand-wired block below — bit-identical with stitching
            # off — instead of retrying the broken planned dispatch; a
            # failing one is quarantined first if the breaker may
            # degrade from its failure, else the failure raises.
            if not _breaker.is_open(pkey):
                try:
                    plan = planner.plan_model(cfg, b, s, stitch=rt.stitch,
                                              **plan_kw)
                    out, _ = L.run_planned_layer(
                        plan.layer, p, x, cfg, positions=positions, rt=rt,
                        cache=cache, page_table=page_table)
                    return out
                except Exception as e:  # noqa: BLE001 - degrade below
                    if not _breaker.degradable(e):
                        raise
                    _breaker.record_failure(
                        pkey, reason=f"{type(e).__name__}: {e}")
        h = L.rmsnorm(x, p["ln1"]["w"], cfg.norm_eps)
        mix, _ = L.paged_attention_block(
            p["mix"], h, cfg, positions=positions, cache=cache,
            page_table=page_table, kernel_ops=rt.kernel_ops,
            block=rt.paged_block)
        x = x + mix
        h2 = L.rmsnorm(x, p["ln2"]["w"], cfg.norm_eps)
        return x + L.feed_forward(p["ff"], h2, cfg)

    def _run_layers(self, params: dict, x: torch.Tensor,
                    positions: torch.Tensor, cache: list,
                    page_table: torch.Tensor) -> torch.Tensor:
        for p, c in zip(params["layers"], cache):
            x = self._apply_layer(p, x, positions, c, page_table)
        return x

    def _unembed(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(x, params["final_norm"]["w"], self.cfg.norm_eps)
        return x @ params["lm_head"]

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> list:
        """One contiguous ``{"k", "v", "pos"}`` cache per layer
        (``layers.init_attn_cache``): ``max_len`` slots, or a ring of
        ``min(max_len, window)`` with a sliding window."""
        return [L.init_attn_cache(self.cfg, batch, max_len, self.device)
                for _ in range(self.cfg.n_layers)]

    def _run_cached(self, params: dict, x: torch.Tensor,
                    positions: torch.Tensor, cache: list) -> torch.Tensor:
        for p, c in zip(params["layers"], cache):
            x = self._apply_block(p, x, positions, c)
        return x

    @torch.no_grad()
    def prefill(self, params: dict, tokens: torch.Tensor, cache: list
                ) -> tuple[torch.Tensor, list]:
        """The prompts' k/v into a fresh ``init_cache`` cache, IN PLACE.
        tokens: (B, P), every prompt of the same length.  Returns (the
        last prompt token's logits (B, V), cache)."""
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x = self._embed(params, tokens)
        x = self._run_cached(params, x, positions, cache)
        return self._unembed(params, x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params: dict, cache: list, tokens: torch.Tensor,
                    pos: torch.Tensor) -> tuple[torch.Tensor, list]:
        """One lock-step decode token for the whole batch, its k/v
        written into ``cache`` IN PLACE.  tokens: (B,); pos: a 0-d int
        tensor, the absolute position every row writes — a tensor on
        the model's device, so that a captured step reads it from
        there.  Returns (logits (B, V), cache)."""
        positions = pos.reshape(1).to(torch.int32)
        x = self._embed(params, tokens[:, None])
        x = self._run_cached(params, x, positions, cache)
        return self._unembed(params, x)[:, 0], cache

    # ------------------------------------------------------------------
    def init_paged_cache(self, n_pages: int, page_size: int) -> list:
        """One ``{"k_pages", "v_pages"}`` pool of shape ``(n_pages,
        n_kv_heads, page_size, dh)`` per layer, no batch dim — the
        engine's page tables map requests onto pages, and page 0 is the
        scratch page (``serving.kv_pages``)."""
        cfg = self.cfg
        shape = (n_pages, cfg.n_kv_heads, page_size, cfg.dh)
        dt = getattr(torch, cfg.dtype)
        return [{"k_pages": torch.zeros(shape, dtype=dt, device=self.device),
                 "v_pages": torch.zeros(shape, dtype=dt, device=self.device)}
                for _ in range(cfg.n_layers)]

    @torch.no_grad()
    def prefill_paged(self, params: dict, tokens: torch.Tensor, cache: list,
                      page_table: torch.Tensor, length: int
                      ) -> tuple[torch.Tensor, list]:
        """One request's prefill into its pages.

        tokens: (1, S) prompt padded to a page multiple; ``length`` is
        the real prompt length — padding rows get position -1, so their
        kv lands on the scratch page and their logits are never read.
        Returns (logits of the last REAL token (1, V), cache)."""
        b, s = tokens.shape
        ar = torch.arange(s, dtype=torch.int32, device=tokens.device)
        positions = torch.where(ar < length, ar, -1)[None, :].expand(b, s)
        x = self._embed(params, tokens)
        x = self._run_layers(params, x, positions, cache, page_table)
        logits = self._unembed(params, x[:, max(length - 1, 0)][:, None])
        return logits[:, 0], cache

    @torch.no_grad()
    def decode_step_paged(self, params: dict, cache: list,
                          tokens: torch.Tensor, positions: torch.Tensor,
                          page_table: torch.Tensor
                          ) -> tuple[torch.Tensor, list]:
        """One ragged decode step over the whole slot batch.

        tokens: (B,) last emitted token per slot; positions: (B,)
        absolute position each slot writes this step (-1 = inactive
        slot: kv goes to the scratch page, logits are ignored);
        page_table: (B, max_pages).  Returns (logits (B, V), cache)."""
        pos2 = positions.to(torch.int32)[:, None]
        x = self._embed(params, tokens[:, None])
        x = self._run_layers(params, x, pos2, cache, page_table)
        return self._unembed(params, x)[:, 0], cache
