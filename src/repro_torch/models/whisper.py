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
    param_specs() / cache_specs(batch)     -> weight and cache layouts

Under a mesh (``Runtime(rules=..., mesh=...)``) it runs as ``LM`` does
(``lm.Sharded``): whole tensors in and out, this rank's rows and shards
inside, the blocks tensor-parallel, Megatron-SP under ``rules.seq``
where the dim divides a side's sequence (the encoder's 1500 frames over
16 do not: it runs tensor-parallel alone).  The layouts are the JAX
package's: ``enc_pos`` and ``dec_pos`` FSDP over ``d_model``, the
vocab's embedding over the model dim or, where the dim does not divide
the vocab (51865), over ``d_model``; the self-attention cache on its
slots over the model dim, the cross-attention cache whole over it
(batch-sharded only).  The encoder output, gathered whole over the
sequence, feeds every decoder layer's cross-attention.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import tree as T
from ..dist.collectives import shard_dims
from . import layers as L
from .config import ModelConfig
from .lm import Runtime, Sharded, _meta, remat_call

#: rows of the decoder's learned positions, as in the JAX package
DEC_POSITIONS = 65536


class EncDec(Sharded):
    POSITIONS = "dec_pos"

    def __init__(self, cfg: ModelConfig, rt: Optional[Runtime] = None,
                 device="cuda"):
        if cfg.encoder is None:
            raise ValueError(f"{cfg.name} has no encoder; decoder-only "
                             f"configs are models.lm.LM's")
        self.cfg = cfg
        self.rt = rt or Runtime()
        self.device = torch.device(device)
        self._specs = None
        self._embed_scale = None
        if self.rt.mesh is not None:
            self._check_mesh()

    # ------------------------------------------------------------------
    def init_params(self, seed: int) -> dict:
        """Seeded random weights made on ``self.device``; under a mesh
        this rank's blocks of them, made a layer at a time."""
        cfg, dev = self.cfg, self.device
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        dt = getattr(torch, cfg.dtype)
        d = cfg.d_model
        specs = self.param_specs() if self.rt.mesh is not None else None

        def place(tree, spec):
            if specs is None:
                return tree
            return T.map_tree(
                lambda t, sp: shard_dims(t, sp, self.rt.mesh), tree, spec)

        def enc_layer():
            return place({"ln1": L.init_norm(cfg, dev),
                          "attn": L.init_attention(gen, cfg, dev),
                          "ln2": L.init_norm(cfg, dev),
                          "ff": L.init_mlp(gen, cfg, dev)},
                         specs and specs["enc_layers"][0])

        def dec_layer():
            return place({"ln1": L.init_norm(cfg, dev),
                          "self_attn": L.init_attention(gen, cfg, dev),
                          "ln_x": L.init_norm(cfg, dev),
                          "cross_attn": L.init_attention(gen, cfg, dev),
                          "ln2": L.init_norm(cfg, dev),
                          "ff": L.init_mlp(gen, cfg, dev)},
                         specs and specs["dec_layers"][0])

        params = {
            "enc_pos": L.dense_init(gen, (cfg.encoder.n_frames, d), dt, dev,
                                    scale=0.02),
            "enc_norm": L.init_norm(cfg, dev),
            "embed": L.dense_init(gen, (cfg.vocab, d), dt, dev, scale=0.02),
            "dec_pos": L.dense_init(gen, (DEC_POSITIONS, d), dt, dev,
                                    scale=0.02),
            "final_norm": L.init_norm(cfg, dev),
        }
        if specs is not None:
            params = place(params, {k: specs[k] for k in params})
        params["enc_layers"] = [enc_layer()
                                for _ in range(cfg.encoder.n_layers)]
        params["dec_layers"] = [dec_layer() for _ in range(cfg.n_layers)]
        return params

    def abstract_params(self) -> dict:
        """``init_params``' tree as ``meta`` tensors (``LM``'s)."""
        return EncDec(self.cfg, Runtime(), device="meta").init_params(0)

    def _enc_specs(self) -> dict:
        cfg, rules = self.cfg, self.rt.rules
        return {"ln1": L.specs_norm(cfg, rules),
                "attn": L.specs_attention(cfg, rules),
                "ln2": L.specs_norm(cfg, rules),
                "ff": L.specs_mlp(cfg, rules)}

    def _dec_specs(self) -> dict:
        cfg, rules = self.cfg, self.rt.rules
        return {"ln1": L.specs_norm(cfg, rules),
                "self_attn": L.specs_attention(cfg, rules),
                "ln_x": L.specs_norm(cfg, rules),
                "cross_attn": L.specs_cross_attention(cfg, rules),
                "ln2": L.specs_norm(cfg, rules),
                "ff": L.specs_mlp(cfg, rules)}

    def param_specs(self) -> dict:
        """The weights' layouts, the JAX package's (``dist.sharding``):
        a tree mirroring ``init_params``."""
        cfg, rules = self.cfg, self.rt.rules
        return {
            "enc_pos": rules.spec(None, "data"),
            "enc_norm": L.specs_norm(cfg, rules),
            "embed": (rules.spec("model", "data") if self._vocab_ok()
                      else rules.spec(None, "model")),
            "dec_pos": rules.spec(None, "data"),
            "final_norm": L.specs_norm(cfg, rules),
            "enc_layers": [self._enc_specs()
                           for _ in range(cfg.encoder.n_layers)],
            "dec_layers": [self._dec_specs() for _ in range(cfg.n_layers)],
        }

    def cache_specs(self, batch_size: int) -> list:
        """``init_cache``'s layouts, the JAX package's: the batch over
        its placement, the self-attention k/v on their slots over the
        model dim (``pos`` whole), the cross-attention k/v whole over it
        (the 1500 frames do not divide over 16)."""
        rules = self.rt.rules
        b = rules.batch_spec(batch_size, self.rt.mesh)
        kv = (b, None, rules.model, None)
        ckv = (b, None, None, None)
        return [{"self": {"k": kv, "v": kv, "pos": (None,)},
                 "cross": {"k": ckv, "v": ckv}}
                for _ in range(self.cfg.n_layers)]

    # ------------------------------------------------------------------
    def _encode(self, params: dict, frames: torch.Tensor,
                ctx: Optional[L.Mesh] = None,
                grad: str = "sum") -> torch.Tensor:
        """frames: (B, T, D) frame embeddings (this rank's rows under a
        mesh), taken in the model's type -> the encoder output (B, T, D),
        whole over the sequence.  Under sequence parallelism (``ctx``'s,
        where the dim divides T) the encoder runs on this rank's block
        of the frames and its output is gathered over the sequence, the
        gradient summed over the ranks (``grad="sum"``) or this rank's
        block of it (``"own"``: every rank's consumers alike)."""
        cfg, rt = self.cfg, self.rt
        t = frames.shape[1]
        pe = self._whole(params["enc_pos"], self._spec("enc_pos"), ctx)[:t]
        x = frames.to(pe.dtype)
        sp = ctx.seq if ctx is not None else None
        if sp is not None:
            x, pe = sp.shard(x, 1), sp.shard(sp.enter(pe), 0)
        x = x + pe
        positions = torch.arange(t, dtype=torch.int32, device=x.device)
        specs = self._enc_specs()

        def layer(p, x):
            p = self._gathered(p, specs, ctx)
            h = self._norm(p["ln1"], x, ctx)
            x = x + L.attention_block(p["attn"], h, cfg, positions=positions,
                                      bkv=rt.bkv, causal=False, ctx=ctx)
            return x + L.mlp_block(p["ff"], self._norm(p["ln2"], x, ctx),
                                   cfg, ctx)

        for p in params["enc_layers"]:
            x = remat_call(rt, layer, p, x)
        x = self._norm(params["enc_norm"], x, ctx)
        return sp.gather(x, 1, grad) if sp is not None else x

    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T, D) frame embeddings, taken in the model's
        type -> the encoder output (B, T, D)."""
        b = frames.shape[0]
        out = self._encode(params, self._local(frames, b),
                           self._ctx(b, frames.shape[1]))
        return self._global(out, b)

    def _cross_input(self, params: dict, frames: torch.Tensor, batch: int,
                     seq: int) -> tuple:
        """(the encoder output for the decoder's cross-attention, the
        decoder's ``ctx``) of this rank's ``frames`` under a global batch
        of ``batch`` rows and a decoder sequence of ``seq``.  Where each
        rank's cross-attention uses the output in part (its heads, or
        its block of the decoder's sequence) the gradient is summed over
        the tensor-parallel dim; where every rank runs every head on the
        whole sequence (``layers._split_heads``), each keeps its own."""
        ctx = self._ctx(batch, seq)
        enc_ctx = self._ctx(batch, frames.shape[1])
        tp = self._tp
        partial = tp is not None and (ctx.seq is not None
                                      or L._split_heads(self.cfg, tp))
        enc = self._encode(params, frames, enc_ctx,
                           "sum" if partial else "own")
        if partial and enc_ctx.seq is None:
            enc = tp.enter(enc)
        return enc, ctx

    def _decode(self, params: dict, tokens: torch.Tensor,
                positions: torch.Tensor, enc_out: Optional[torch.Tensor],
                cache: Optional[list] = None,
                ctx: Optional[L.Mesh] = None) -> torch.Tensor:
        """The decoder stack over tokens (B, S) at ``positions`` (S,),
        before the final norm (this rank's block of the sequence under
        ``ctx``'s sequence parallelism).  Cache-free (``cache`` None:
        the cross-attention reads ``enc_out``), a prefill (both: each
        layer's cross k/v are written into its cache), or a decode step
        (``enc_out`` None: they are read from it)."""
        cfg, rt = self.cfg, self.rt
        x = self._embed(params, tokens, positions, ctx=ctx)
        specs = self._dec_specs()

        def layer(p, c, x, enc_out):
            p = self._gathered(p, specs, ctx)
            h = self._norm(p["ln1"], x, ctx)
            x = x + L.attention_block(p["self_attn"], h, cfg,
                                      positions=positions, bkv=rt.bkv,
                                      cache=c.get("self"), ctx=ctx)
            hx = self._norm(p["ln_x"], x, ctx)
            x = x + L.cross_attention_block(p["cross_attn"], hx, cfg,
                                            enc_out=enc_out,
                                            kv_cache=c.get("cross"),
                                            ctx=ctx)
            return x + L.mlp_block(p["ff"], self._norm(p["ln2"], x, ctx),
                                   cfg, ctx)

        for i, p in enumerate(params["dec_layers"]):
            if cache is None:
                x = remat_call(rt, layer, p, {}, x, enc_out)
            else:
                x = layer(p, cache[i], x, enc_out)
        return x

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        return torch.arange(tokens.shape[1], dtype=torch.int32,
                            device=tokens.device)

    def forward(self, params: dict, tokens: torch.Tensor,
                frames: torch.Tensor) -> torch.Tensor:
        """Cache-free: tokens (B, S) over frames (B, T, D) -> logits
        (B, S, V)."""
        b = tokens.shape[0]
        tokens = self._local(tokens, b)
        enc, ctx = self._cross_input(params, self._local(frames, b), b,
                                     tokens.shape[1])
        x = self._decode(params, tokens, self._positions(tokens), enc,
                         ctx=ctx)
        return self._global(self._unembed(params, x, ctx), b)

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """batch: {"frames", "tokens", "labels"} (-100 = masked); mean
        cross-entropy against the tied embedding (``_mean_ce``: by
        ``chunked_ce``'s sums, the global-batch mean on every rank)."""
        b = batch["tokens"].shape[0]
        tokens = self._local(batch["tokens"], b)
        enc, ctx = self._cross_input(params, self._local(batch["frames"], b),
                                     b, tokens.shape[1])
        x = self._norm(params["final_norm"],
                       self._decode(params, tokens, self._positions(tokens),
                                    enc, ctx=ctx), ctx)
        return self._mean_ce(params, x, self._local(batch["labels"], b), b,
                             ctx)

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> list:
        """Per decoder layer ``{"self": init_attn_cache (max_len slots),
        "cross": {"k", "v"} (B, Hkv, n_frames, dh)}`` in the model's
        type; the cross k/v are filled by ``prefill``.  Under a mesh this
        rank's blocks of them (``cache_specs``)."""
        cfg = self.cfg
        shape = (batch, cfg.n_kv_heads, cfg.encoder.n_frames, cfg.dh)
        dt = getattr(torch, cfg.dtype)
        return self._materialise(
            [{"self": L.init_attn_cache(cfg, batch, max_len, "meta"),
              "cross": {"k": _meta(shape, dt), "v": _meta(shape, dt)}}
             for _ in range(cfg.n_layers)], batch)

    @torch.no_grad()
    def prefill(self, params: dict, tokens: torch.Tensor, cache: list,
                frames: torch.Tensor) -> tuple[torch.Tensor, list]:
        """Encode ``frames``, write every layer's cross k/v and the
        prompts' self-attention k/v (positions 0..S-1) into a fresh
        ``init_cache`` cache IN PLACE.  Returns (the last prompt token's
        logits (B, V), cache)."""
        b = tokens.shape[0]
        tokens = self._local(tokens, b)
        enc, ctx = self._cross_input(params, self._local(frames, b), b,
                                     tokens.shape[1])
        x = self._decode(params, tokens, self._positions(tokens), enc,
                         cache, ctx)
        last = x[:, -1:]
        if ctx is not None and ctx.seq is not None:
            last = ctx.seq.all_gather(last, 1)[:, -1:]
        return self._global(self._unembed(params, last)[:, 0], b), cache

    @torch.no_grad()
    def decode_step(self, params: dict, cache: list, tokens: torch.Tensor,
                    pos: torch.Tensor) -> tuple[torch.Tensor, list]:
        """One lock-step token for the whole batch at position ``pos``
        (a 0-d int tensor on the model's device, so that a captured step
        reads it there), its self-attention k/v written into ``cache``
        IN PLACE, the cross-attention over the cached encoder k/v.
        Returns (logits (B, V), cache)."""
        b = tokens.shape[0]
        ctx = self._ctx(b)
        x = self._decode(params, self._local(tokens, b)[:, None],
                         pos.reshape(1).to(torch.int32), None, cache, ctx)
        return self._global(self._unembed(params, x)[:, 0], b), cache
