"""Decoder-only LM, dense (qwen3, granite, codeqwen, the pixtral
backbone with its prefix embeddings), mixture of experts (olmoe,
mixtral), hybrid (recurrentgemma: RG-LRU blocks and local attention
in a repeating ``pattern``) or state-space (mamba2: Mamba-2 blocks
without an MLP): the cache-free forward and loss,
fixed-batch decoding over a contiguous cache, and paged serving of the
attention-only stacks, hand-wired or run from the fusion planner's
plans (``Runtime(planner=True)``: the cache-free forward and paged
serving of the configs the planner can plan, on one card or under a
mesh; the others run hand-wired, as in the JAX package).

The JAX package's ``LM`` scans a stack of stacked layer parameters
(``n_super`` repeats of the pattern) and runs the remainder as an
unscanned tail; here the layers are one Python list in the same order
(``layer_kinds``), walked by a loop, with each layer's kind kept on the
model (``LM.kinds``) rather than in the parameter tree; parameters are
dicts of tensors created directly on the model's device, and execution
is eager (``launch.serve.generate`` and ``serving.engine`` capture a
decode step in a CUDA graph on the card).  Every cache and recurrent
state is written IN PLACE, where the JAX package returns updated
copies.  The API:

    init_params(seed)                      -> params on ``device``
    forward(params, tokens[, prefix_embeds]) -> logits (B, P + S, V)
    loss(params, batch)                    -> scalar mean cross-entropy
                                              (under autograd after
                                              ``requires_grad(params)``)
    init_cache(batch, max_len)             -> per-layer {k, v, pos},
                                              {conv, lru} or {conv, ssm}
    prefill(params, tokens, cache[, prefix_embeds])
                                           -> (last logits (B, V), cache)
    decode_step(params, cache, tokens, pos)
    init_paged_cache(n_pages, page_size)   -> per-layer page pools
    prefill_paged(params, tokens, cache, page_table, length)
    decode_step_paged(params, cache, tokens, positions, page_table)
    param_specs() / cache_specs(batch)     -> weight and cache layouts

Under a mesh (``Runtime(rules=..., mesh=...)``, every family, and the
planned path of the configs the planner can plan) every rank holds its
shards of the
weights (``param_specs``, placed by ``launch.steps.shard_params``) and
of the caches (``cache_specs``), and runs the same program on them: the
entry points take and return whole tensors, as the JAX package's global
arrays, each rank computing its block of the batch (``batch_placement``)
and gathering the outputs.  The weights of dims sharded over other mesh
dims than the tensor-parallel one (FSDP) are gathered just before their
layer runs.  The embedding and ``lm_head`` are vocab-parallel where the
model dim divides the vocab: the lookup sums the ranks' rows, the
logits are gathered, and the loss reduces its logsumexp over the ranks
(``_ce_sums``); else their ``d_model`` is sharded and gathered whole.
The recurrent blocks' states follow ``cache_specs``: the conv state
whole, the RG-LRU's and Mamba-2's this rank's channels or heads.
``Sharded`` holds what ``models.whisper.EncDec`` shares of this.  Under
a mesh every step runs eagerly.

``loss`` runs under autograd on a mesh too: every collective on its
path is a differentiable one (``dist.collectives``: the FSDP gather
reduce-scatters its gradient over the dims the batch is split on, the
sums take an identity backward, a replicated input entering
rank-specific columns an all-reduce).  Its value is the global-batch
mean on every rank, and each rank's gradients are its part of that
mean's: ``launch.steps.make_train_step`` sums them over the batch's mesh
dims for the leaves replicated there.

Under ``Rules(seq=...)`` the residual stream between blocks is this
rank's block of the sequence, (B_local, S / n, D), and the norms run on
the shard with their weights entered (each rank's gradient is its
block's part).  Over the tensor-parallel dim (Megatron-SP) the
vocab-parallel embedding reduce-scatters its rows over the sequence (a
``d_model``-sharded one cuts its whole rows to the block), each block
gathers its normed input and reduce-scatters its output
(``layers._enter``/``_leave``), and the loss and the logits gather the
shard first.  Over a dim of its own without tensor parallelism (the
``zero3`` regime's multi-pod form, ``tp=None``) every weight is gathered
whole, its gradient summed over the sequence's dim as over the batch's;
the embedding's whole rows are cut to the block, the blocks keep the
rank's rows (``layers._attention_rows``, ``layers._whole_mixer``), and
each rank's cross-entropy sums over its block of the sequence, the sums
reduced.  A call whose sequence the dim does not divide (a decode step)
runs without sequence parallelism, as the JAX package's ``constrain``
drops a mesh dim that does not divide.  A paged prompt's prefill runs
sequence-parallel where the dim divides it, and the sequence is
gathered before its last real token's logits are read.

``Runtime(remat=True)`` runs each pattern super-block of the cache-free
stack (one layer of a dense stack; ``(rglru, rglru, attn)`` of
recurrentgemma's) under ``torch.utils.checkpoint`` — the JAX package's
``jax.checkpoint`` on its scanned body; the unscanned tail runs plain,
as there — and ``remat_policy="dots"`` keeps the 2-D weight products'
outputs (``aten.mm``/``aten.addmm``: ``dots_with_no_batch_dims_saveable``)
and recomputes the rest.  The default is off, where the JAX package's
is on: each of the port's drivers is the counterpart of a JAX driver
that turns it off.  ``abstract_params`` gives ``init_params``' tree on
the ``meta`` device.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from .. import tree as T
from ..core import planner
from ..dist.collectives import axis, gather_dims, shard_dims
from ..dist.sharding import Rules, batch_placement, local_shape, mesh_shape
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
    planner: bool = False   # run every cache-free and paged-serving
    # attention block from core.planner's plan for its phase
    # (forward/prefill/decode) — chains carved and glue stitched from
    # the config alone under the H100 descriptor; with kernel_ops, each
    # fused MLP chain runs as the fused_mlp_chain CUDA kernel.  A config
    # the planner cannot plan (core.planner.plannable: MoE, hybrid,
    # state-space) and a contiguous cache run hand-wired.
    stitch: bool = True     # planner mode only: stitch memory-bound
    # glue into carved chains as prologue/epilogue; False is
    # bit-identical to the hand-wired layer.
    sentinels: bool = False  # arm the in-step activation health
    # monitor (reliability/sentinels.py::healthy): the serving engine
    # checks prefill and decode logits for NaN/Inf/explosion and evicts
    # the offending slot with the honest "health" outcome.
    rules: Rules = dataclasses.field(default_factory=Rules.disabled)
    mesh: Optional[object] = None   # a DeviceMesh ("data", "model"):
    # every rank runs on its shards (launch.mesh); None = one device.
    dist_decode_attn: bool = False  # decode attention over a
    # sequence-sharded contiguous cache by per-rank partial softmax (no
    # gather), and the paged-ring regime over page-table columns;
    # serving.engine sets it when the tuner picks a ring regime.
    dist_decode_pipelined: bool = False  # the ring combine as the
    # per-hop pipelined ring (paged-ring-pipelined) instead of the
    # serial all-reduces.
    remat: bool = False     # activation recomputation of the cache-free
    # stack's pattern super-blocks under autograd (the JAX package's
    # default is True; see the module doc)
    remat_policy: Optional[str] = None  # None: recompute everything;
    # "dots": keep the 2-D weight products' outputs


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: the outputs of the 2-D
    weight GEMMs ``x @ W`` lowers to are kept, every other op (the
    batched attention products included) is recomputed."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(rt: Runtime, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` with ``rt``'s
    policy when ``rt.remat`` and autograd records (the non-reentrant
    form: the block's collectives run again in its backward)."""
    if not (rt.remat and torch.is_grad_enabled()):
        return fn(*args)
    if rt.remat_policy not in (None, "dots"):
        raise ValueError(f"remat_policy {rt.remat_policy!r}: None or "
                         f"'dots'")
    kw = {}
    if rt.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Every layer's kind in the JAX package's order: the pattern
    ``n_layers // len(pattern)`` times (its scanned super-blocks), then
    the unscanned tail — recurrentgemma's 26 = 8 x (rglru, rglru, attn)
    + (rglru, rglru)."""
    pat = list(cfg.pattern)
    n_super = cfg.n_layers // len(pat)
    return pat * n_super + pat[:cfg.n_layers - n_super * len(pat)]


def _chunk_len(s: int, target: int = 512) -> int:
    """Largest divisor of s that is <= target."""
    best = 1
    for c in range(1, min(s, target) + 1):
        if s % c == 0:
            best = c
    return best


def _ce_sums(hidden: torch.Tensor, unembed_w: torch.Tensor,
             labels: torch.Tensor, tp=None) -> tuple:
    """(sum of the token losses, count of unmasked tokens) over sequence
    chunks of at most 512.  Under a tensor-parallel dim ``tp``,
    ``unembed_w`` holds this rank's block of the vocab columns, and the
    row max (without a gradient), the sum of exponentials and the
    target logit are reduced over the dim (a vocab-parallel
    cross-entropy); ``hidden`` has entered the rank's columns
    (``Axis.enter``)."""
    b, s, _ = hidden.shape
    c = _chunk_len(s)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, c):
        lf = (hidden[:, c0:c0 + c] @ unembed_w).float()
        lch = labels[:, c0:c0 + c]
        if tp is None:
            lse = torch.logsumexp(lf, dim=-1)
            tgt = torch.gather(lf, -1, lch.clamp(min=0)[..., None])[..., 0]
        else:
            vl = lf.shape[-1]
            m = tp.all_reduce(lf.detach().amax(dim=-1), op="max")
            lse = m + torch.log(tp.reduce(
                torch.exp(lf - m[..., None]).sum(dim=-1)))
            t = lch - tp.index * vl
            own = (t >= 0) & (t < vl)
            tgt = tp.reduce(torch.where(own, torch.gather(
                lf, -1, t.clamp(0, vl - 1)[..., None])[..., 0], 0.0))
        mask = (lch >= 0).float()
        tot = tot + ((lse - tgt) * mask).sum()
        cnt = cnt + mask.sum()
    return tot, cnt


def chunked_ce(hidden: torch.Tensor, unembed_w: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over sequence chunks of at most 512, so the
    (B, S, V) logits never exist at once.  hidden: (B, S, D) after the
    final norm; unembed_w: (D, V); labels: (B, S), -100 masked.  Each
    chunk's logits are taken in the model's type and reduced in f32
    (logsumexp minus the target logit)."""
    tot, cnt = _ce_sums(hidden, unembed_w, labels)
    return tot / torch.clamp(cnt, min=1.0)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def requires_grad(params: dict) -> dict:
    """Mark every parameter leaf as requiring grad, IN PLACE, so that
    ``LM.loss`` back-propagates into ``.grad`` (the training step's
    counterpart of ``jax.value_and_grad``); returns ``params``.  The
    kernel path stays forward-only: ``Runtime(kernel_ops=True)`` raises
    under grad mode, as the JAX kernels have no gradient."""
    for t in T.leaves(params):
        t.requires_grad_(True)
    return params


_MIXERS = {"attn": (L.init_attention, None),
           "rglru": (L.init_rglru, "rglru"),
           "mamba": (L.init_mamba, "ssm")}


class Sharded:
    """What ``LM`` and ``models.whisper.EncDec`` share under a mesh: the
    checks of the ``Runtime``'s rules, this rank's axes and the blocks'
    ``layers.Mesh``, whole tensors in and this rank's rows out (and
    back), the FSDP gather of a weight, the norms under sequence
    parallelism, the embedding lookup and the learned positions, the
    logits and the loss's cross-entropy, vocab-parallel or over
    ``d_model`` blocks.  A subclass sets ``cfg``, ``rt``, ``device``,
    ``_specs`` (None), ``_embed_scale`` and ``POSITIONS`` (its learned
    positions' parameter name) and gives ``param_specs``."""

    POSITIONS = "pos_embed"

    def _check_mesh(self) -> None:
        """Every family runs under a mesh, hand-wired or planned, with
        sequence parallelism over the tensor-parallel dim or, without
        tensor parallelism, over a dim of its own (the ``zero3``
        regime's multi-pod form).  An activation dim other than the
        weights' model dim, and sequence parallelism over another dim
        than a tensor-parallel one (a regime the JAX package has not),
        refuse."""
        rules = self.rt.rules
        if rules.tp not in (None, rules.model):
            raise NotImplementedError(
                f"activation dim {rules.tp!r} differs from the weights' "
                f"model dim {rules.model!r}")
        if rules.tp is not None and rules.seq not in (None, rules.tp):
            raise NotImplementedError(
                f"sequence parallelism over {rules.seq!r} beside tensor "
                f"parallelism over {rules.tp!r}: sequence parallelism "
                f"runs over the tensor-parallel dim, or without one")

    def _n_model(self) -> int:
        """The model dim's size (1 without a mesh or a model dim)."""
        rules, mesh = self.rt.rules, self.rt.mesh
        return (mesh_shape(mesh)[rules.model]
                if mesh is not None and rules.model else 1)

    def _vocab_ok(self) -> bool:
        """Whether the embedding and ``lm_head`` are laid out
        vocab-parallel: the model dim divides the vocab (else
        ``d_model`` is sharded)."""
        return self.cfg.vocab % max(self._n_model(), 1) == 0

    def _vocab_sharded(self) -> bool:
        """Whether this rank holds a block of the vocab (a
        tensor-parallel dim over a vocab-parallel layout)."""
        return self._tp is not None and self._vocab_ok()

    @functools.cached_property
    def _tp(self):
        """This rank's tensor-parallel ``Axis`` (None: no mesh, or a
        dim of size 1), taken from the mesh's process groups on first
        use, so that layouts can be asked of a mesh stand-in."""
        rt = self.rt
        return axis(rt.mesh, rt.rules.tp) if rt.mesh is not None else None

    @functools.cached_property
    def _sp(self):
        """This rank's sequence-parallel ``Axis`` over ``rules.seq``'s
        dim — the tensor-parallel one, or a dim of its own without
        tensor parallelism (None: no mesh, no ``rules.seq``, or a dim
        of size 1)."""
        rt = self.rt
        return axis(rt.mesh, rt.rules.seq) if rt.mesh is not None else None

    def _ctx(self, batch: int, seq: int = 1) -> Optional[L.Mesh]:
        """The blocks' view of the mesh for a call of ``batch`` rows of
        ``seq`` positions: sequence-parallel where ``rules.seq`` is set
        and its dim divides ``seq``."""
        rt = self.rt
        if rt.mesh is None:
            return None
        sp = self._sp
        if sp is not None and seq % sp.size:
            sp = None
        return L.Mesh(rt.mesh, rt.rules, self._tp, batch,
                      rt.dist_decode_attn, rt.dist_decode_pipelined, sp)

    def _norm(self, p: dict, x: torch.Tensor,
              ctx: Optional[L.Mesh]) -> torch.Tensor:
        """``apply_norm``; under sequence parallelism on this rank's
        block of the sequence, its weights entered (each rank's gradient
        is its block's part)."""
        if ctx is not None and ctx.seq is not None:
            p = {k: ctx.seq.enter(w) for k, w in p.items()}
        return L.apply_norm(p, x, self.cfg)

    def _bax(self, batch: int):
        """The batch dim's mesh axis for a global batch of ``batch``
        (None: whole on every rank)."""
        rt = self.rt
        if rt.mesh is None:
            return None
        return axis(rt.mesh, batch_placement(rt.rules, rt.mesh, batch))

    def _local(self, t, batch: int):
        bx = self._bax(batch)
        return bx.shard(t, 0) if (bx is not None and t is not None) else t

    def _global(self, t: torch.Tensor, batch: int) -> torch.Tensor:
        bx = self._bax(batch)
        return bx.all_gather(t, 0) if bx is not None else t

    def _whole(self, t: torch.Tensor, layout,
               ctx: Optional[L.Mesh] = None) -> torch.Tensor:
        """A weight gathered along every dim sharded over a mesh dim
        other than the tensor-parallel one (the FSDP gather); under
        autograd its gradient is summed over the mesh dims that split
        ``ctx``'s batch or its sequence (each rank applies the weight to
        its own rows) and sliced over the others."""
        rt = self.rt
        if rt.mesh is None:
            return t
        summed = ()
        if ctx is not None:
            summed = batch_placement(rt.rules, rt.mesh, ctx.batch)
            if ctx.seq is not None:
                summed = summed + ctx.seq.names
        return gather_dims(t, layout, rt.mesh, keep=(rt.rules.tp,),
                           summed=summed)

    def _spec(self, name: str):
        if self._specs is None:
            self._specs = self.param_specs()
        return self._specs[name]

    def _materialise(self, caches, batch: int):
        """``caches`` (whole, on the ``meta`` device) made on the model's
        device, each tensor this rank's block of it under
        ``cache_specs(batch)`` on a mesh: zeros, and -1 in the int32
        slot positions (``pos``: every slot empty)."""
        mesh = self.rt.mesh
        specs = self.cache_specs(batch) if mesh is not None else caches

        def make(t, lay):
            shape = (local_shape(t.shape, lay, mesh) if mesh is not None
                     else t.shape)
            return torch.full(shape, -1 if t.dtype == torch.int32 else 0,
                              dtype=t.dtype, device=self.device)
        return T.map_tree(make, caches, specs)

    def _gathered(self, p: dict, specs: dict,
                  ctx: Optional[L.Mesh] = None) -> dict:
        """A layer's weights under ``specs`` FSDP-gathered (``_whole``)
        just before it runs; ``p`` itself without a mesh."""
        if self.rt.mesh is None:
            return p
        return T.map_tree(lambda t, sp: self._whole(t, sp, ctx), p, specs)

    def _embed(self, params: dict, tokens: torch.Tensor,
               positions: torch.Tensor,
               prefix_embeds: Optional[torch.Tensor] = None,
               ctx: Optional[L.Mesh] = None) -> torch.Tensor:
        """The token embeddings — tied ones times ``_embed_scale`` —
        after the prefix embeddings, if any, plus the learned positions
        (``POSITIONS``) at ``positions`` of a config without rope.  Under
        sequence parallelism the ranks' partial rows of a vocab-parallel
        lookup (the prefix on one rank) are reduce-scattered over the
        sequence, whole rows of a ``d_model``-sharded one cut to this
        rank's block, and the positions added to that block."""
        sp = ctx.seq if ctx is not None else None
        partial = sp is not None and self._vocab_sharded()
        x = self._lookup(params, tokens, ctx, summed=not partial)
        if self._embed_scale is not None:
            x = x * self._embed_scale
        if prefix_embeds is not None:
            pre = prefix_embeds.to(x.dtype)
            if partial and sp.index:
                pre = torch.zeros_like(pre)
            x = torch.cat([pre, x], dim=1)
        if sp is not None:
            x = sp.scatter(x, 1) if partial else sp.shard(x, 1)
            positions = sp.shard(positions, -1)
        if not self.cfg.use_rope:
            pe = self._whole(params[self.POSITIONS],
                             self._spec(self.POSITIONS), ctx)
            if sp is not None:
                pe = sp.enter(pe)
            x = x + pe[positions.long()]
        return x

    def _mean_ce(self, params: dict, x: torch.Tensor, labels: torch.Tensor,
                 batch: int, ctx: Optional[L.Mesh] = None,
                 n_pre: int = 0) -> torch.Tensor:
        """The loss's tail: x (this rank's rows after the final norm,
        ``n_pre`` prefix rows first; its block of the sequence under
        sequence parallelism) against ``labels`` (this rank's rows,
        aligned with the tokens; -100 masked), the mean cross-entropy by
        ``_ce_sums`` over the global batch of ``batch`` rows.

        Under a tensor-parallel dim a vocab-parallel unembedding takes
        x whole (gathered over the sequence, or entered) and reduces the
        logsumexp over the vocab's ranks; a ``d_model``-sharded one is
        gathered whole — under sequence parallelism each rank then sums
        its block of the sequence (the weight's gradient summed over the
        ranks, the sums reduced), under tensor parallelism alone every
        rank the whole (each keeping its block of the weight's
        gradient).  Under sequence parallelism without a tensor-parallel
        dim each rank sums its block of the sequence against the whole
        unembedding, the sums reduced.  The sums are reduced over the
        batch's mesh dims: every rank returns the global-batch mean."""
        tp = self._tp
        sp = ctx.seq if ctx is not None else None
        w = self._unembed_w(params, ctx)
        if sp is not None and not self._vocab_sharded():
            labels = torch.nn.functional.pad(labels, (n_pre, 0),
                                             value=-100)
            tot, cnt = _ce_sums(x, tp.gather(w, 0) if tp is not None
                                else w, sp.shard(labels, 1))
            tot, cnt = sp.reduce(tot), sp.all_reduce(cnt)
        else:
            if sp is not None:
                x = sp.gather(x, 1)
            x = x[:, n_pre:]
            if tp is not None and not self._vocab_sharded():
                w = tp.gather(w, 0, "own")      # d_model rows gathered
            elif tp is not None and sp is None:
                x = tp.enter(x)
            tot, cnt = _ce_sums(x, w, labels,
                                tp if self._vocab_sharded() else None)
        bx = self._bax(batch)
        if bx is not None:
            tot, cnt = bx.reduce(tot), bx.all_reduce(cnt)
        return tot / torch.clamp(cnt, min=1.0)

    def _lookup(self, params: dict, tokens: torch.Tensor,
                ctx: Optional[L.Mesh] = None,
                summed: bool = True) -> torch.Tensor:
        """The embedding rows of ``tokens``.  Under a tensor-parallel dim
        each rank holds a block of the vocab rows (or of ``d_model``
        where the dim does not divide the vocab): it looks up the tokens
        it holds, zeros elsewhere, and the ranks' rows are summed
        (returned unsummed when not ``summed``) or the ``d_model``
        blocks gathered — each rank's gradient its block's, summed over
        the ranks under ``ctx``'s sequence parallelism, where each uses
        its block of the sequence."""
        emb = self._whole(params["embed"], self._spec("embed"), ctx)
        tp = self._tp
        if tp is None:
            return emb[tokens]
        if emb.shape[0] == self.cfg.vocab:
            sp = ctx is not None and ctx.seq is not None
            return tp.gather(emb[tokens], -1, "sum" if sp else "own")
        t = tokens - tp.index * emb.shape[0]
        own = (t >= 0) & (t < emb.shape[0])
        rows = (emb[t.clamp(0, emb.shape[0] - 1)] * own[..., None]).to(
            emb.dtype)
        return tp.reduce(rows) if summed else rows

    def _unembed_w(self, params: dict,
                   ctx: Optional[L.Mesh] = None) -> torch.Tensor:
        """The (D, V) unembedding: the tied embedding transposed, or
        ``lm_head`` — under a mesh this rank's vocab columns (or
        ``d_model`` rows, where the model dim does not divide the
        vocab)."""
        if self.cfg.tie_embeddings:
            return self._whole(params["embed"], self._spec("embed"),
                               ctx).t()
        return self._whole(params["lm_head"], self._spec("lm_head"), ctx)

    @staticmethod
    def _seq_len(tokens: torch.Tensor,
                 prefix_embeds: Optional[torch.Tensor]) -> int:
        return tokens.shape[1] + (prefix_embeds.shape[1]
                                  if prefix_embeds is not None else 0)

    def _unembed(self, params: dict, x: torch.Tensor,
                 ctx: Optional[L.Mesh] = None) -> torch.Tensor:
        """Logits of the final norm of x, gathered whole over the vocab
        (or summed over ``d_model`` blocks) under a tensor-parallel
        dim; under ``ctx``'s sequence parallelism x is this rank's block
        of the sequence, normed there and gathered."""
        x = self._norm(params["final_norm"], x, ctx)
        if ctx is not None and ctx.seq is not None:
            x = ctx.seq.gather(x, 1)
        w = self._unembed_w(params)
        if self._tp is None:
            return x @ w
        if self._vocab_sharded():
            return self._tp.all_gather(x @ w, -1)
        return self._tp.all_reduce(self._tp.shard(x, -1) @ w)


class LM(Sharded):
    def __init__(self, cfg: ModelConfig, rt: Optional[Runtime] = None,
                 device="cuda"):
        kinds = layer_kinds(cfg)
        bad = [k for k in set(kinds) if k not in _MIXERS
               or (_MIXERS[k][1] and getattr(cfg, _MIXERS[k][1]) is None)]
        if cfg.family == "encdec" or bad:
            raise NotImplementedError(
                f"LM runs decoder-only stacks of {sorted(_MIXERS)} layers, "
                f"each with its config field; {cfg.name} is {cfg.family} "
                f"with layers {sorted(set(kinds))} (an encoder-decoder "
                f"config is models.whisper.EncDec's)")
        self.cfg = cfg
        self.rt = rt or Runtime()
        self.device = torch.device(device)
        self.kinds = kinds
        self._specs = None
        if self.rt.mesh is not None:
            self._check_mesh()
        # tied embeddings are scaled by sqrt(d_model) rounded to the
        # config's type, as the JAX package's weakly typed scalar is (a
        # constant of the model, which a step with the weights upcast to
        # f32 keeps)
        self._embed_scale = (
            float(torch.tensor(math.sqrt(cfg.d_model),
                               dtype=getattr(torch, cfg.dtype)))
            if cfg.tie_embeddings else None)

    def param_specs(self) -> dict:
        """The weights' layouts (``dist.sharding``), a tree mirroring
        ``init_params``: each projection's columns or rows over the
        model dim (FSDP over the data dims while ``rules.fsdp``), norms
        whole, and the vocab dims over the model dim where it divides
        the vocab (else ``d_model`` is)."""
        cfg, rules = self.cfg, self.rt.rules
        n_model, vocab_ok = self._n_model(), self._vocab_ok()
        specs = {"embed": (rules.spec("model", "data") if vocab_ok
                           else rules.spec(None, "model")),
                 "final_norm": L.specs_norm(cfg, rules)}
        if not cfg.use_rope:
            specs["pos_embed"] = rules.spec(None, "data")
        if not cfg.tie_embeddings:
            specs["lm_head"] = (rules.spec("data", "model") if vocab_ok
                                else rules.spec("model", None))
        specs["layers"] = [self._layer_specs(kind, n_model)
                           for kind in self.kinds]
        return specs

    def _layer_specs(self, kind: str, n_model: int) -> dict:
        cfg, rules = self.cfg, self.rt.rules
        mix = {"attn": L.specs_attention, "mamba": L.specs_mamba,
               "rglru": L.specs_rglru}[kind]
        s = {"ln1": L.specs_norm(cfg, rules), "mix": mix(cfg, rules)}
        if cfg.d_ff > 0:
            s["ln2"] = L.specs_norm(cfg, rules)
            s["ff"] = (L.specs_moe(cfg, rules, n_model) if cfg.moe
                       else L.specs_mlp(cfg, rules))
        return s

    def cache_specs(self, batch_size: int) -> list:
        """The layouts of ``init_cache``'s caches, one per layer: the
        batch over its placement; an attention cache's kv heads over the
        model dim where they divide it, else its slots (``pos`` whole);
        a recurrent state's channels over the model dim (the conv's
        whole: ``layers.rglru_block`` and ``mamba_block`` run it on every
        channel), a Mamba-2 state's heads where the dim divides them.
        Without tensor parallelism (``rules.tp`` None: every block runs
        every head on its weights gathered whole) the caches are whole
        but for the batch."""
        cfg, rules, mesh = self.cfg, self.rt.rules, self.rt.mesh
        b = rules.batch_spec(batch_size, mesh)
        n_model = self._n_model()
        model = rules.model if rules.tp is not None else None
        out = []
        for kind in self.kinds:
            if kind == "attn":
                if model is None:
                    kv = (b, None, None, None)
                elif cfg.n_kv_heads % max(n_model, 1) == 0 \
                        and cfg.n_kv_heads >= n_model:
                    kv = (b, model, None, None)
                else:
                    kv = (b, None, model, None)
                out.append({"k": kv, "v": kv, "pos": (None,)})
            elif kind == "mamba":
                s = cfg.ssm
                heads = s.expand * cfg.d_model // s.head_dim
                out.append({"conv": (b, None, None),
                            "ssm": (b, model if heads % n_model == 0
                                    else None, None, None)})
            else:
                out.append({"conv": (b, None, None), "lru": (b, model)})
        return out

    # ------------------------------------------------------------------
    # mesh helpers: global tensors in and out, shards inside
    # ------------------------------------------------------------------
    def _layer(self, p: dict, kind: str,
               ctx: Optional[L.Mesh] = None) -> dict:
        if self.rt.mesh is None:
            return p
        return self._gathered(p, self._layer_specs(kind, self._n_model()),
                              ctx)

    # ------------------------------------------------------------------
    def init_params(self, seed: int) -> dict:
        """Seeded random weights made on ``self.device`` (a full-width
        bf16 model is never staged on the host).  A layer has ``ln2`` and
        ``ff`` only where ``d_ff > 0`` (mamba2 has none); a config with
        tied embeddings has no ``lm_head``, one without rope has learned
        positions ``pos_embed`` (65536 rows)."""
        cfg, dev = self.cfg, self.device
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        dt = getattr(torch, cfg.dtype)
        specs = self.param_specs() if self.rt.mesh is not None else None

        def place(tree, spec):
            # under a mesh: this rank's block of each whole tensor, so
            # that at most one layer is ever whole on the device
            if specs is None:
                return tree
            return T.map_tree(
                lambda t, sp: shard_dims(t, sp, self.rt.mesh), tree, spec)

        layers = []
        for i, kind in enumerate(self.kinds):
            layer = {"ln1": L.init_norm(cfg, dev),
                     "mix": _MIXERS[kind][0](gen, cfg, dev)}
            if cfg.d_ff > 0:
                layer["ln2"] = L.init_norm(cfg, dev)
                layer["ff"] = (L.init_moe(gen, cfg, dev) if cfg.moe
                               else L.init_mlp(gen, cfg, dev))
            layers.append(place(layer, specs and specs["layers"][i]))
        params = {
            "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), dt, dev,
                                  scale=0.02),
            "final_norm": L.init_norm(cfg, dev),
        }
        if not cfg.use_rope:
            params["pos_embed"] = L.dense_init(gen, (65536, cfg.d_model), dt,
                                               dev, scale=0.02)
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab),
                                             dt, dev)
        if specs is not None:
            params = place(params, {k: specs[k] for k in params})
        params["layers"] = layers
        return params

    def abstract_params(self) -> dict:
        """``init_params``' tree as ``meta`` tensors of its shapes and
        types, whole (the global shapes, as the JAX package's
        ``eval_shape`` gives): ``init_params`` itself run on the ``meta``
        device without a mesh, so that no second table of shapes
        exists."""
        return LM(self.cfg, Runtime(), device="meta").init_params(0)

    # ------------------------------------------------------------------
    def _apply_block(self, kind: str, p: dict, x: torch.Tensor,
                     positions: torch.Tensor,
                     cache: Optional[dict] = None,
                     ctx: Optional[L.Mesh] = None) -> torch.Tensor:
        """One block of ``kind`` over its contiguous ``cache`` (a KV
        cache or a recurrent state, written in place), or cache-free
        (the forward).  A cache-free attention block of a config the
        planner can plan runs from its plan under
        ``Runtime(planner=True)`` (``_planned_block``); a cached block,
        and any block of an MoE, hybrid or state-space config, runs
        hand-wired, as in the JAX package.  The attention layers use
        ``cfg.attn_window``."""
        cfg, rt = self.cfg, self.rt
        p = self._layer(p, kind, ctx)
        if (rt.planner and cache is None and kind == "attn"
                and planner.plannable(cfg)):
            out = self._planned_block(p, x, positions, ctx)
            if out is not None:
                return out
        h = self._norm(p["ln1"], x, ctx)
        if kind == "attn":
            x = x + L.attention_block(p["mix"], h, cfg, positions=positions,
                                      bkv=rt.bkv, kernel_ops=rt.kernel_ops,
                                      cache=cache, ctx=ctx)
        elif kind == "mamba":
            x = x + L.mamba_block(p["mix"], h, cfg, state=cache, ctx=ctx)
        else:
            x = x + L.rglru_block(p["mix"], h, cfg, state=cache, ctx=ctx)
        if cfg.d_ff <= 0:
            return x
        h2 = self._norm(p["ln2"], x, ctx)
        return x + L.feed_forward(p["ff"], h2, cfg, ctx)

    def _planned_block(self, p: dict, x: torch.Tensor,
                       positions: torch.Tensor, ctx: Optional[L.Mesh],
                       cache: Optional[dict] = None,
                       page_table: Optional[torch.Tensor] = None
                       ) -> Optional[torch.Tensor]:
        """One attention block from the planner's plan — the forward's
        without a cache, the paged prefill's or decode step's with one —
        at the call's global batch and sequence (the prefix included;
        under a mesh ``ctx.batch`` and the sequence over its dim, as
        the JAX package executes it), on this rank's shards
        (``layers.run_planned_layer``).  None where the hand-wired block
        must serve it: its plan key is quarantined (circuit breaker),
        or planning or running it failed in a way the breaker may
        degrade from (the failure is recorded first); any other failure
        raises."""
        from ..reliability import breaker as _breaker
        cfg, rt = self.cfg, self.rt
        b, s = x.shape[:2]
        if ctx is not None:
            b = ctx.batch
            s = s * (ctx.seq.size if ctx.seq is not None else 1)
        plan_kw = {}
        if cache is not None:
            ps = cache["k_pages"].shape[2]
            plan_kw = dict(phase="prefill" if s > 1 else "decode",
                           paged=ps, kv_len=page_table.shape[1] * ps)
        pkey = planner.plan_key(cfg, b, s, rt.stitch, **plan_kw)
        if _breaker.is_open(pkey):
            return None
        try:
            plan = planner.plan_model(cfg, b, s, stitch=rt.stitch,
                                      **plan_kw)
            out, _ = L.run_planned_layer(plan.layer, p, x, cfg,
                                         positions=positions, rt=rt,
                                         cache=cache, page_table=page_table,
                                         ctx=ctx)
            return out
        except Exception as e:  # noqa: BLE001 - degrade below
            if not _breaker.degradable(e):
                raise
            _breaker.record_failure(pkey, reason=f"{type(e).__name__}: {e}")
            return None

    def _positions(self, tokens: torch.Tensor,
                   prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        """Positions 0.. over the prefix embeddings and the tokens."""
        n_pre = prefix_embeds.shape[1] if prefix_embeds is not None else 0
        return torch.arange(n_pre + tokens.shape[1], dtype=torch.int32,
                            device=tokens.device)

    def _hidden(self, params: dict, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                ctx: Optional[L.Mesh] = None) -> torch.Tensor:
        """The cache-free stack's output before the final norm, over the
        prefix embeddings and the tokens (this rank's batch rows under a
        mesh, its block of the sequence under sequence parallelism):
        each pattern super-block under ``remat_call``, then the tail."""
        positions = self._positions(tokens, prefix_embeds)
        x = self._embed(params, tokens, positions, prefix_embeds, ctx)
        layers = list(zip(self.kinds, params["layers"]))
        pat = len(self.cfg.pattern)
        n_stack = len(layers) // pat * pat
        for i in range(0, n_stack, pat):
            x = remat_call(self.rt, self._blocks, layers[i:i + pat], x,
                           positions, ctx)
        return self._blocks(layers[n_stack:], x, positions, ctx)

    def _blocks(self, layers: list, x: torch.Tensor,
                positions: torch.Tensor,
                ctx: Optional[L.Mesh]) -> torch.Tensor:
        for kind, p in layers:
            x = self._apply_block(kind, p, x, positions, ctx=ctx)
        return x

    def forward(self, params: dict, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """The cache-free forward: tokens (B, S) after prefix embeddings
        (B, P, D) -> logits (B, P + S, V)."""
        b = tokens.shape[0]
        ctx = self._ctx(b, self._seq_len(tokens, prefix_embeds))
        x = self._hidden(params, self._local(tokens, b),
                         self._local(prefix_embeds, b), ctx)
        return self._global(self._unembed(params, x, ctx), b)

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """batch: {"tokens", "labels"[, "prefix_embeds"]}, labels aligned
        with tokens (-100 = masked); the prefix rows are dropped after
        the final norm.  Mean cross-entropy by ``chunked_ce``: no (B, S,
        V) logits (``_mean_ce``).  Under a mesh every rank returns the
        global-batch mean, and under autograd its gradients are its
        rows' part of it (the sum of the tokens' losses goes through
        ``Axis.reduce``)."""
        b = batch["tokens"].shape[0]
        prefix = self._local(batch.get("prefix_embeds"), b)
        tokens = self._local(batch["tokens"], b)
        ctx = self._ctx(b, self._seq_len(tokens, prefix))
        x = self._norm(params["final_norm"],
                       self._hidden(params, tokens, prefix, ctx), ctx)
        return self._mean_ce(params, x, self._local(batch["labels"], b), b,
                             ctx, prefix.shape[1] if prefix is not None
                             else 0)

    # ------------------------------------------------------------------
    def _apply_layer(self, p: dict, x: torch.Tensor,
                     positions: torch.Tensor, cache: dict,
                     page_table: torch.Tensor,
                     ctx: Optional[L.Mesh] = None) -> torch.Tensor:
        """One paged block: planned where the ``Runtime`` asks for it and
        the planner can plan the config (``_planned_block``), else
        hand-wired."""
        cfg, rt = self.cfg, self.rt
        p = self._layer(p, "attn", ctx)
        if rt.planner and planner.plannable(cfg):
            out = self._planned_block(p, x, positions, ctx, cache,
                                      page_table)
            if out is not None:
                return out
        h = self._norm(p["ln1"], x, ctx)
        mix, _ = L.paged_attention_block(
            p["mix"], h, cfg, positions=positions, cache=cache,
            page_table=page_table, kernel_ops=rt.kernel_ops,
            block=rt.paged_block, ctx=ctx)
        x = x + mix
        h2 = self._norm(p["ln2"], x, ctx)
        return x + L.feed_forward(p["ff"], h2, cfg, ctx)

    def _run_layers(self, params: dict, x: torch.Tensor,
                    positions: torch.Tensor, cache: list,
                    page_table: torch.Tensor,
                    ctx: Optional[L.Mesh] = None) -> torch.Tensor:
        for p, c in zip(params["layers"], cache):
            x = self._apply_layer(p, x, positions, c, page_table, ctx)
        return x

    def init_cache(self, batch: int, max_len: int) -> list:
        """One contiguous cache per layer: an attention layer's ``{"k",
        "v", "pos"}`` (``layers.init_attn_cache``) of ``max_len`` slots,
        or a ring of ``min(max_len, cfg.attn_window)`` with a window; an
        RG-LRU layer's state ``{"conv": (B, K-1, w) in the model's type,
        "lru": (B, w) f32}``; a Mamba-2 layer's ``{"conv": (B, K-1, din +
        2N) in the model's type, "ssm": (B, H, N, P) f32}``.  Under a mesh
        this rank's blocks of them (``cache_specs``)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        caches = []
        for kind in self.kinds:
            if kind == "attn":
                caches.append(L.init_attn_cache(cfg, batch, max_len, "meta"))
            elif kind == "mamba":
                s = cfg.ssm
                din = s.expand * cfg.d_model
                n = s.n_groups * s.d_state
                caches.append({
                    "conv": _meta((batch, s.conv_kernel - 1, din + 2 * n),
                                  dt),
                    "ssm": _meta((batch, din // s.head_dim, n, s.head_dim),
                                 torch.float32)})
            else:
                w = int(cfg.rglru.width_mult * cfg.d_model)
                caches.append({
                    "conv": _meta((batch, cfg.rglru.conv_kernel - 1, w), dt),
                    "lru": _meta((batch, w), torch.float32)})
        return self._materialise(caches, batch)

    def _run_cached(self, params: dict, x: torch.Tensor,
                    positions: torch.Tensor, cache: list,
                    ctx: Optional[L.Mesh] = None) -> torch.Tensor:
        for kind, p, c in zip(self.kinds, params["layers"], cache):
            x = self._apply_block(kind, p, x, positions, c, ctx)
        return x

    @torch.no_grad()
    def prefill(self, params: dict, tokens: torch.Tensor, cache: list,
                prefix_embeds: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, list]:
        """The prompts, after their prefix embeddings (B, P, D) if any,
        into a fresh ``init_cache`` cache, IN PLACE.  tokens: (B, S),
        every prompt of the same length.  Returns (the last prompt
        token's logits (B, V), cache)."""
        b = tokens.shape[0]
        tokens = self._local(tokens, b)
        prefix_embeds = self._local(prefix_embeds, b)
        positions = self._positions(tokens, prefix_embeds)
        ctx = self._ctx(b, positions.shape[0])
        x = self._embed(params, tokens, positions, prefix_embeds, ctx)
        x = self._run_cached(params, x, positions, cache, ctx)
        last = x[:, -1:]
        if ctx is not None and ctx.seq is not None:
            last = ctx.seq.all_gather(last, 1)[:, -1:]
        return self._global(self._unembed(params, last)[:, 0], b), cache

    @torch.no_grad()
    def decode_step(self, params: dict, cache: list, tokens: torch.Tensor,
                    pos: torch.Tensor) -> tuple[torch.Tensor, list]:
        """One lock-step decode token for the whole batch, its k/v
        written into ``cache`` IN PLACE.  tokens: (B,); pos: a 0-d int
        tensor, the absolute position every row writes — a tensor on
        the model's device, so that a captured step reads it from
        there.  Returns (logits (B, V), cache)."""
        b = tokens.shape[0]
        positions = pos.reshape(1).to(torch.int32)
        ctx = self._ctx(b)
        x = self._embed(params, self._local(tokens, b)[:, None], positions,
                        ctx=ctx)
        x = self._run_cached(params, x, positions, cache, ctx)
        return self._global(self._unembed(params, x)[:, 0], b), cache

    # ------------------------------------------------------------------
    def init_paged_cache(self, n_pages: int, page_size: int) -> list:
        """One ``{"k_pages", "v_pages"}`` pool of shape ``(n_pages,
        n_kv_heads, page_size, dh)`` per layer, no batch dim — the
        engine's page tables map requests onto pages, and page 0 is the
        scratch page (``serving.kv_pages``).  Attention-only stacks
        without prefix embeddings, as in the JAX package: a recurrent
        state is per request, not per position.  Under a mesh a pool
        holds this rank's kv heads, or every kv head (the ring regimes,
        kv heads the tensor-parallel dim does not divide, or no such
        dim); under sequence parallelism too, as every rank writes the
        whole prompt's k/v of the heads it holds."""
        cfg = self.cfg
        if any(kind != "attn" for kind in self.kinds):
            raise NotImplementedError(
                f"paged serving covers attention-only stacks; "
                f"{cfg.name} has pattern {cfg.pattern}")
        if cfg.n_prefix_embeds:
            raise NotImplementedError(
                f"paged serving does not thread prefix embeddings yet; "
                f"{cfg.name} needs n_prefix_embeds={cfg.n_prefix_embeds}")
        hkv = cfg.n_kv_heads
        if (self._tp is not None and hkv % self._tp.size == 0
                and not self.rt.dist_decode_attn):
            hkv //= self._tp.size       # this rank's kv heads
        shape = (n_pages, hkv, page_size, cfg.dh)
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
        Under sequence parallelism, where its dim divides S, each rank's
        residual stream is its block of the prompt, gathered before the
        last real token's logits are read.
        Returns (logits of the last REAL token (1, V), cache)."""
        b0 = tokens.shape[0]
        tokens, page_table = (self._local(tokens, b0),
                              self._local(page_table, b0))
        b, s = tokens.shape
        ar = torch.arange(s, dtype=torch.int32, device=tokens.device)
        positions = torch.where(ar < length, ar, -1)[None, :].expand(b, s)
        ctx = self._ctx(b0, s)
        x = self._embed(params, tokens, positions, ctx=ctx)
        x = self._run_layers(params, x, positions, cache, page_table, ctx)
        if ctx is not None and ctx.seq is not None:
            x = ctx.seq.all_gather(x, 1)
        logits = self._unembed(params, x[:, max(length - 1, 0)][:, None])
        return self._global(logits[:, 0], b0), cache

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
        b = tokens.shape[0]
        tokens, positions, page_table = (
            self._local(t, b) for t in (tokens, positions, page_table))
        pos2 = positions.to(torch.int32)[:, None]
        x = self._embed(params, tokens[:, None], pos2)
        x = self._run_layers(params, x, pos2, cache, page_table,
                             self._ctx(b))
        return self._global(self._unembed(params, x)[:, 0], b), cache
