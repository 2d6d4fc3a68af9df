"""Step builders of the training path — the port of the JAX package's
``repro.launch.steps``.

``make_train_step`` returns the eager step ``launch.train`` runs: the
loss under autograd, the backward into each parameter's ``.grad``, the
AdamW update in place, and the gradients cleared.  Under a mesh (the
model's ``Runtime``) params and state are this rank's shards: the loss
is the global-batch mean on every rank and each rank's gradients are
its part of it, so ``reduce_gradients`` sums each leaf's gradient over
the mesh dims that split the batch and that its layout replicates it on
(the FSDP gather's backward has already reduce-scattered the others),
and the clip's global norm counts every shard once.

``make_compressed_train_step`` and ``init_grad_residuals`` reduce the
gradients over a data axis with int8 error feedback
(``dist.compression``): params replicated, the model without a mesh,
each rank's loss a mean over its own rows, the reduced gradient divided
by the axis size.  The JAX package stacks the residuals on a leading
axis of data shards; here each rank holds its own row.

``shard_params`` places a whole parameter tree as this rank's blocks
under the model's ``param_specs``; ``state_layouts`` gives the layouts
of a training state (params, optimizer state), for its checkpoints.

The dry run's step specs: ``make_prefill_step`` and
``make_decode_step``, ``input_specs`` (``meta`` tensors of every model
input of a cell, the JAX package's shapes and types), ``batch_specs``
(their layouts), ``abstract_cache`` (``init_cache`` on the ``meta``
device, whole) and ``local_specs`` — the counterpart of
``shardings_for`` — which maps each whole ``meta`` tensor to one rank's
block of it under its layout (``dist.sharding.local_shape``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import tree as T
from ..dist import compression
from ..dist.collectives import axis, layout_dims, shard_dims
from ..configs import ShapeCell
from ..dist.sharding import Rules, batch_placement, local_shape
from ..models.config import ModelConfig
from ..models.lm import LM, Runtime, _meta, requires_grad
from ..models.whisper import EncDec
from ..optim.adamw import AdamW, cosine_schedule


def build_model(cfg: ModelConfig, rt: Optional[Runtime] = None,
                device="cuda"):
    """The model of ``cfg``: ``EncDec`` for an encoder-decoder config,
    ``LM`` for every other."""
    if cfg.family == "encdec":
        return EncDec(cfg, rt, device=device)
    return LM(cfg, rt, device=device)


def default_optimizer(total_steps: int = 10000) -> AdamW:
    return AdamW(lr=cosine_schedule(3e-4, warmup=200, total=total_steps))


def reduce_gradients(model, grads: list, layouts: list,
                     batch_size: int) -> None:
    """Sum each gradient leaf (this rank's block, IN PLACE) over the
    mesh dims that split a batch of ``batch_size`` and that its layout
    does not shard it on: the leaves replicated over the batch's ranks,
    whose gradients each rank holds only its rows' part of.  One
    all-reduce for each mesh dim and type, over the leaves concatenated."""
    mesh = model.rt.mesh
    dims = batch_placement(model.rt.rules, mesh, batch_size)
    for n in dims:
        ax = axis(mesh, n)
        if ax is None:
            continue
        groups: dict[torch.dtype, list] = {}
        for g, lay in zip(grads, layouts):
            if n not in layout_dims(lay):
                groups.setdefault(g.dtype, []).append(g)
        for gs in groups.values():
            flat = ax.all_reduce(torch.cat([g.reshape(-1) for g in gs]))
            for g, part in zip(gs, torch.split(flat, [g.numel()
                                                      for g in gs])):
                g.copy_(part.view_as(g))


def make_train_step(model, opt: AdamW):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    info)`` for an ``LM`` or an ``EncDec``: params and state updated in
    place and returned, ``info`` ``{"loss", "grad_norm", "lr"}`` as 0-d
    tensors.  batch: ``{"tokens", "labels"[, "prefix_embeds" | "frames"]}``
    on the model's device (a vision config's prefix embeddings, an
    encoder-decoder's frames), the whole global batch.  Under a mesh
    params and state are this rank's shards (``shard_params``); the
    gradients are reduced over the batch's mesh dims
    (``reduce_gradients``), the norm is the whole tree's, and every
    rank's ``info["loss"]`` is the global-batch mean."""
    mesh = model.rt.mesh

    def train_step(params, opt_state, batch):
        requires_grad(params)
        loss = model.loss(params, batch)
        loss.backward()
        grads = [p.grad for p in T.leaves(params)]
        layouts = None
        if mesh is not None:
            layouts = T.leaves(model.param_specs(), like=params)
            reduce_gradients(model, grads, layouts,
                             batch["tokens"].shape[0])
        info = opt.update(params, grads, opt_state, layouts, mesh)
        for p in T.leaves(params):
            p.grad = None
        info["loss"] = loss.detach()
        return params, opt_state, info
    return train_step


def init_grad_residuals(params):
    """Zero error-feedback residuals: for every parameter leaf an f32
    tensor of shape ``(1, *leaf.shape)``, this rank's row of the JAX
    package's residuals stacked on a leading axis of data shards (a
    checkpoint gathers the rows, ``state_layouts``)."""
    return T.map_tree(lambda p: torch.zeros((1,) + tuple(p.shape),
                                            dtype=torch.float32,
                                            device=p.device), params)


def stack_groups(model, params) -> list:
    """Each parameter leaf's quantization group, in leaf order.  The JAX
    package scans its stacked layers, so a leaf of its tree holds one
    weight of every layer at one place of the stack, and its per-tensor
    int8 scale covers them all: the group of ``layers/<i>/...`` is the
    pattern position of ``i`` within the scanned super-blocks (the
    unscanned tail's layers are groups of their own), of an
    encoder-decoder's ``enc_layers/<i>/...`` and ``dec_layers/<i>/...``
    its side; every other leaf is a group of its own."""
    cfg = model.cfg
    pat = len(cfg.pattern)
    n_stack = cfg.n_layers // pat * pat
    keys = []
    for path, _ in T.leaves_with_paths(params):
        parts = path.split("/")
        if parts[0] == "layers" and int(parts[1]) < n_stack:
            parts[1] = f"b{int(parts[1]) % pat}"
        elif parts[0] in ("enc_layers", "dec_layers"):
            parts[1] = "stack"
        keys.append("/".join(parts))
    return keys


def make_compressed_train_step(model, opt: AdamW, mesh=None,
                               axis_name: str = "data"):
    """Train step with int8 error-feedback gradient reduction
    (``dist.compression.compressed_psum``) over the ``axis_name`` mesh
    dim (one rank without a mesh).  Each rank takes its block of the
    global batch's rows, the loss and gradients of its rows under
    autograd, quantizes ``grad + residual`` to int8 and all-reduces the
    dequantized payload; the residual carries the quantization error
    into the next step.  The quantization is per tensor of the JAX
    package's tree: the leaves of one ``stack_groups`` group (a weight
    of every scanned layer) are quantized together, with one scale.
    The reduced gradient, divided by the dim's size, goes to the
    optimizer, which every rank runs alike on its replicated params.

    Signature: ``(params, opt_state, residuals, batch) -> (params,
    opt_state, residuals, info)``.  ``model`` runs without a mesh
    (``Rules.disabled()``): the params are replicated over the dim."""
    if model.rt.mesh is not None:
        raise ValueError("the compressed step replicates the params: "
                         "build the model without a mesh")
    ax = axis(mesh, axis_name) if mesh is not None else None
    n = ax.size if ax is not None else 1
    groups: dict[str, list] = {}

    def train_step(params, opt_state, residuals, batch):
        if ax is not None:
            batch = {k: ax.shard(v, 0) for k, v in batch.items()}
        requires_grad(params)
        loss = model.loss(params, batch)
        loss.backward()
        leaves, res = T.leaves(params), T.leaves(residuals)
        if not groups:
            for i, key in enumerate(stack_groups(model, params)):
                groups.setdefault(key, []).append(i)
        grads = [None] * len(leaves)
        for idx in groups.values():
            out, new_r = compression.compressed_psum(
                torch.stack([leaves[i].grad for i in idx]),
                torch.stack([res[i][0] for i in idx]), ax)
            for i, r, o in zip(idx, new_r, out):
                res[i][0].copy_(r)
                grads[i] = (o / n).to(leaves[i].grad.dtype)
        for p in leaves:
            p.grad = None
        loss = loss.detach()
        if ax is not None:
            loss = ax.all_reduce(loss)
        info = opt.update(params, grads, opt_state)
        info["loss"] = loss / n
        return params, opt_state, residuals, info
    return train_step


def state_layouts(model, state) -> tuple:
    """The layouts of a training state ``(params, opt_state[,
    residuals])``, a tree mirroring it, for its checkpoints: the params
    as the model's mesh lays them out (replicated without one), the
    optimizer's moments and master weights as their params, its step
    whole, and each rank's residual row on the data dim (gathered, the
    JAX package's stacked residuals)."""
    params = state[0]
    specs = (model.param_specs() if model.rt.mesh is not None
             else T.map_tree(lambda t: (None,) * t.dim(), params))
    opt = {k: (() if k == "step" else specs) for k in state[1]}
    out = (specs, opt)
    if len(state) > 2:
        out += (T.map_tree(lambda r: ("data",) + (None,) * (r.dim() - 1),
                           state[2]),)
    return out


def shard_params(model, params: dict, device=None) -> dict:
    """This rank's blocks of the whole parameter tree ``params`` (the
    port's own ``init_params`` or ``models.convert``'s carried JAX
    weights) under ``model.param_specs()`` on ``model.rt.mesh``, each a
    contiguous tensor on ``device`` (default: the model's), leaf by
    leaf, so that the whole tree may be freed after.  Without a mesh:
    the tree itself."""
    mesh = model.rt.mesh
    if mesh is None:
        return params
    dev = model.device if device is None else device
    return T.map_tree(lambda t, sp: shard_dims(t, sp, mesh).to(dev),
                      params, model.param_specs())


def make_prefill_step(model):
    """``prefill_step(params, cache, batch) -> (logits, cache)``: the
    model's prefill of ``batch["tokens"]`` (after ``prefix_embeds``, or
    over ``frames``) into ``cache``."""
    def prefill_step(params, cache, batch):
        if "frames" in batch:
            return model.prefill(params, batch["tokens"], cache,
                                 batch["frames"])
        return model.prefill(params, batch["tokens"], cache,
                             prefix_embeds=batch.get("prefix_embeds"))
    return prefill_step


def make_decode_step(model):
    """``decode_step(params, cache, batch) -> (logits, cache)``: one
    token ``batch["tokens"]`` (B,) at position ``batch["pos"]``."""
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch["tokens"],
                                 batch["pos"])
    return decode_step


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> dict:
    """``meta`` stand-ins for every model input of this cell, whole:
    tokens and labels int32, ``frames`` (an encoder-decoder's) and
    ``prefix_embeds`` (a vision prefix's, which the tokens make room
    for) in the config's type; a decode cell's one token a row and its
    0-d position."""
    b, s = shape.batch, shape.seq
    dt = getattr(torch, cfg.dtype)
    tok = torch.int32
    if shape.kind == "decode":
        return {"tokens": _meta((b,), tok), "pos": _meta((), tok)}
    batch = {}
    if cfg.family == "encdec":
        batch["frames"] = _meta((b, cfg.encoder.n_frames, cfg.d_model), dt)
    elif cfg.n_prefix_embeds:
        batch["prefix_embeds"] = _meta((b, cfg.n_prefix_embeds,
                                        cfg.d_model), dt)
        s -= cfg.n_prefix_embeds
    batch["tokens"] = _meta((b, s), tok)
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), tok)
    return batch


def batch_specs(cfg: ModelConfig, shape: ShapeCell, rules: Rules,
                mesh) -> dict:
    """The layouts of ``input_specs``' tensors: the batch dim over its
    placement (``Rules.batch_spec``), every other dim whole, the
    position whole."""
    lead = rules.batch_spec(shape.batch, mesh)
    return {k: (() if k == "pos" else (lead,) + (None,) * (v.dim() - 1))
            for k, v in input_specs(cfg, shape).items()}


def abstract_cache(model, cfg: ModelConfig, shape: ShapeCell):
    """``init_cache(batch, seq)`` of the cell on the ``meta`` device,
    whole (the global shapes; ``local_specs`` under
    ``model.cache_specs`` gives a rank's)."""
    return build_model(cfg, Runtime(), device="meta").init_cache(
        shape.batch, shape.seq)


def local_specs(tree, layouts, mesh):
    """Each whole ``meta`` tensor of ``tree`` as one rank's block of it
    under its layout in ``layouts`` (a tree mirroring ``tree``), on
    ``mesh`` — the counterpart of the JAX package's ``shardings_for``."""
    return T.map_tree(lambda t, lay: _meta(local_shape(t.shape, lay, mesh),
                                           t.dtype), tree, layouts)
