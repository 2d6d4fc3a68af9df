"""Dense decoder-only LM (qwen3) for paged serving.

The JAX package's ``LM`` scans a stack of stacked layer parameters;
here the layers are a Python list walked by a loop, parameters are
dicts of tensors created directly on the model's device, and execution
is eager.  The API the serving engine drives:

    init_params(seed)                      -> params on ``device``
    init_paged_cache(n_pages, page_size)   -> per-layer page pools
    prefill_paged(params, tokens, cache, page_table, length)
    decode_step_paged(params, cache, tokens, positions, page_table)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import layers as L
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context threaded through model code."""

    kernel_ops: bool = False  # decode attention through the fused CUDA
    # kernel (kernels.attention) when the tensors are on the card; the
    # gather twin otherwise.
    paged_block: Optional[tuple] = None  # (bq, bkv) tiles the paged
    # regime search picked — serving.engine threads them so the kernel
    # executes the schedule the tuner priced.


class LM:
    def __init__(self, cfg: ModelConfig, rt: Optional[Runtime] = None,
                 device="cuda"):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the port serves dense decoders; {cfg.name} is "
                f"{cfg.family}")
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
                "ff": L.init_mlp(gen, cfg, dev),
            })
        return {
            "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), dt, dev,
                                  scale=0.02),
            "final_norm": {"w": torch.zeros(cfg.d_model, device=dev)},
            "lm_head": L.dense_init(gen, (cfg.d_model, cfg.vocab), dt, dev),
            "layers": layers,
        }

    # ------------------------------------------------------------------
    def _apply_layer(self, p: dict, x: torch.Tensor,
                     positions: torch.Tensor, cache: dict,
                     page_table: torch.Tensor) -> torch.Tensor:
        cfg, rt = self.cfg, self.rt
        h = L.rmsnorm(x, p["ln1"]["w"], cfg.norm_eps)
        mix, _ = L.paged_attention_block(
            p["mix"], h, cfg, positions=positions, cache=cache,
            page_table=page_table, kernel_ops=rt.kernel_ops,
            block=rt.paged_block)
        x = x + mix
        h2 = L.rmsnorm(x, p["ln2"]["w"], cfg.norm_eps)
        return x + L.mlp_block(p["ff"], h2)

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
        x = params["embed"][tokens]
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
        x = params["embed"][tokens[:, None]]
        x = self._run_layers(params, x, pos2, cache, page_table)
        return self._unembed(params, x)[:, 0], cache
