"""Whisper-style encoder-decoder (arXiv:2212.04356), the port of the JAX
package's ``models.whisper.EncDec``.

The conv/mel frontend is a stand-in, as in the JAX package: callers
pass precomputed frame embeddings (B, n_frames, D).  The encoder adds
learned positions ``enc_pos`` and runs bidirectional self-attention and
a gelu MLP per layer, then ``enc_norm``; the decoder adds learned
positions ``dec_pos`` (65536 rows) to its token embeddings and runs
causal self-attention (over a contiguous cache when decoding),
cross-attention over the encoder output and a gelu MLP per layer, then
``final_norm`` and the tied logits ``x @ embed.T`` — unscaled: unlike
``LM``, the embeddings are never multiplied by sqrt(d_model).  Every
norm is a layernorm.  No kernel runs here, as in the JAX package
(which never passes ``kernel_ops``); the ``Runtime`` gives the
streaming twin's kv block.

The JAX package scans stacked layer parameters; here each side's layers
are one Python list (``enc_layers``, ``dec_layers``), walked by a loop,
and every cache is written IN PLACE.  Under ``Runtime(remat=True)``
each encoder layer, and each decoder layer of a cache-free call, runs
under ``lm.remat_call`` (the JAX package's ``jax.checkpoint`` on its
scanned layers).  The API is ``LM``'s, with the frames as the side
input:

    init_params(seed)                      -> params on ``device``
    forward(params, tokens, frames)        -> logits (B, S, V)
    loss(params, batch)                    -> mean cross-entropy of
                                              {"frames", "tokens",
                                              "labels"}
    init_cache(batch, max_len)             -> per decoder layer
                                              {"self": {k, v, pos},
                                              "cross": {k, v}}
    prefill(params, tokens, cache, frames) -> (last logits (B, V), cache)
    decode_step(params, cache, tokens, pos)
"""
from __future__ import annotations

from typing import Optional

import torch

from . import layers as L
from .config import ModelConfig
from .lm import Runtime, chunked_ce, remat_call

#: rows of the decoder's learned positions, as in the JAX package
DEC_POSITIONS = 65536


class EncDec:
    def __init__(self, cfg: ModelConfig, rt: Optional[Runtime] = None,
                 device="cuda"):
        if cfg.encoder is None:
            raise ValueError(f"{cfg.name} has no encoder; decoder-only "
                             f"configs are models.lm.LM's")
        self.cfg = cfg
        self.rt = rt or Runtime()
        if self.rt.mesh is not None:
            raise NotImplementedError(
                f"mesh execution covers the dense family; {cfg.name} "
                f"(encoder-decoder) comes with ROADMAP Queue 1 item 4")
        self.device = torch.device(device)

    # ------------------------------------------------------------------
    def init_params(self, seed: int) -> dict:
        """Seeded random weights made on ``self.device``."""
        cfg, dev = self.cfg, self.device
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        dt = getattr(torch, cfg.dtype)
        d = cfg.d_model

        def enc_layer():
            return {"ln1": L.init_norm(cfg, dev),
                    "attn": L.init_attention(gen, cfg, dev),
                    "ln2": L.init_norm(cfg, dev),
                    "ff": L.init_mlp(gen, cfg, dev)}

        def dec_layer():
            return {"ln1": L.init_norm(cfg, dev),
                    "self_attn": L.init_attention(gen, cfg, dev),
                    "ln_x": L.init_norm(cfg, dev),
                    "cross_attn": L.init_attention(gen, cfg, dev),
                    "ln2": L.init_norm(cfg, dev),
                    "ff": L.init_mlp(gen, cfg, dev)}

        return {
            "enc_pos": L.dense_init(gen, (cfg.encoder.n_frames, d), dt, dev,
                                    scale=0.02),
            "enc_norm": L.init_norm(cfg, dev),
            "embed": L.dense_init(gen, (cfg.vocab, d), dt, dev, scale=0.02),
            "dec_pos": L.dense_init(gen, (DEC_POSITIONS, d), dt, dev,
                                    scale=0.02),
            "final_norm": L.init_norm(cfg, dev),
            "enc_layers": [enc_layer() for _ in range(cfg.encoder.n_layers)],
            "dec_layers": [dec_layer() for _ in range(cfg.n_layers)],
        }

    def abstract_params(self) -> dict:
        """``init_params``' tree as ``meta`` tensors (``LM``'s)."""
        return EncDec(self.cfg, Runtime(), device="meta").init_params(0)

    # ------------------------------------------------------------------
    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T, D) frame embeddings, taken in the model's
        type -> the encoder output (B, T, D)."""
        cfg, rt = self.cfg, self.rt
        t = frames.shape[1]
        x = frames.to(params["enc_pos"].dtype) + params["enc_pos"][:t]
        positions = torch.arange(t, dtype=torch.int32, device=x.device)

        def layer(p, x):
            h = L.apply_norm(p["ln1"], x, cfg)
            x = x + L.attention_block(p["attn"], h, cfg, positions=positions,
                                      bkv=rt.bkv, causal=False)
            return x + L.mlp_block(p["ff"], L.apply_norm(p["ln2"], x, cfg),
                                   cfg)

        for p in params["enc_layers"]:
            x = remat_call(rt, layer, p, x)
        return L.apply_norm(params["enc_norm"], x, cfg)

    def _decode(self, params: dict, tokens: torch.Tensor,
                positions: torch.Tensor, enc_out: Optional[torch.Tensor],
                cache: Optional[list] = None) -> torch.Tensor:
        """The decoder stack over tokens (B, S) at ``positions`` (S,),
        before the final norm.  Cache-free (``cache`` None: the
        cross-attention reads ``enc_out``), a prefill (both: each
        layer's cross k/v are written into its cache), or a decode step
        (``enc_out`` None: they are read from it)."""
        cfg, rt = self.cfg, self.rt
        x = params["embed"][tokens] + params["dec_pos"][positions.long()]

        def layer(p, c, x, enc_out):
            h = L.apply_norm(p["ln1"], x, cfg)
            x = x + L.attention_block(p["self_attn"], h, cfg,
                                      positions=positions, bkv=rt.bkv,
                                      cache=c.get("self"))
            hx = L.apply_norm(p["ln_x"], x, cfg)
            x = x + L.cross_attention_block(p["cross_attn"], hx, cfg,
                                            enc_out=enc_out,
                                            kv_cache=c.get("cross"))
            return x + L.mlp_block(p["ff"], L.apply_norm(p["ln2"], x, cfg),
                                   cfg)

        for i, p in enumerate(params["dec_layers"]):
            if cache is None:
                x = remat_call(rt, layer, p, {}, x, enc_out)
            else:
                x = layer(p, cache[i], x, enc_out)
        return L.apply_norm(params["final_norm"], x, cfg)

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        return torch.arange(tokens.shape[1], dtype=torch.int32,
                            device=tokens.device)

    def forward(self, params: dict, tokens: torch.Tensor,
                frames: torch.Tensor) -> torch.Tensor:
        """Cache-free: tokens (B, S) over frames (B, T, D) -> logits
        (B, S, V)."""
        x = self._decode(params, tokens, self._positions(tokens),
                         self.encode(params, frames))
        return x @ params["embed"].t()

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """batch: {"frames", "tokens", "labels"} (-100 = masked); mean
        cross-entropy by ``chunked_ce`` against the tied embedding."""
        tokens = batch["tokens"]
        x = self._decode(params, tokens, self._positions(tokens),
                         self.encode(params, batch["frames"]))
        return chunked_ce(x, params["embed"].t(), batch["labels"])

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> list:
        """Per decoder layer ``{"self": init_attn_cache (max_len slots),
        "cross": {"k", "v"} (B, Hkv, n_frames, dh)}`` in the model's
        type; the cross k/v are filled by ``prefill``."""
        cfg, dev = self.cfg, self.device
        shape = (batch, cfg.n_kv_heads, cfg.encoder.n_frames, cfg.dh)
        dt = getattr(torch, cfg.dtype)
        return [{"self": L.init_attn_cache(cfg, batch, max_len, dev),
                 "cross": {"k": torch.zeros(shape, dtype=dt, device=dev),
                           "v": torch.zeros(shape, dtype=dt, device=dev)}}
                for _ in range(cfg.n_layers)]

    @torch.no_grad()
    def prefill(self, params: dict, tokens: torch.Tensor, cache: list,
                frames: torch.Tensor) -> tuple[torch.Tensor, list]:
        """Encode ``frames``, write every layer's cross k/v and the
        prompts' self-attention k/v (positions 0..S-1) into a fresh
        ``init_cache`` cache IN PLACE.  Returns (the last prompt token's
        logits (B, V), cache)."""
        x = self._decode(params, tokens, self._positions(tokens),
                         self.encode(params, frames), cache)
        return (x[:, -1] @ params["embed"].t()), cache

    @torch.no_grad()
    def decode_step(self, params: dict, cache: list, tokens: torch.Tensor,
                    pos: torch.Tensor) -> tuple[torch.Tensor, list]:
        """One lock-step token for the whole batch at position ``pos``
        (a 0-d int tensor on the model's device, so that a captured step
        reads it there), its self-attention k/v written into ``cache``
        IN PLACE, the cross-attention over the cached encoder k/v.
        Returns (logits (B, V), cache)."""
        x = self._decode(params, tokens[:, None],
                         pos.reshape(1).to(torch.int32), None, cache)
        return x[:, 0] @ params["embed"].t(), cache
