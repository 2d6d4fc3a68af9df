"""Step builders of the training path — the port of the JAX package's
``repro.launch.steps`` for one device.

``make_train_step`` returns the eager step ``launch.train`` runs: the
loss under autograd, the backward into each parameter's ``.grad``, the
AdamW update in place, and the gradients cleared.  ``shard_params`` is
the counterpart of ``shardings_for``: it places a whole parameter tree
as this rank's blocks under the model's ``param_specs``.  The JAX
package's ``make_compressed_train_step`` and ``init_grad_residuals``
(int8 gradient reduction over a data axis) come with the training half
of ROADMAP Queue 1 item 4; its dry-run specs (``input_specs``,
``batch_specs``, ``abstract_cache``) with Queue 1 item 7.
"""
from __future__ import annotations

from typing import Optional

from .. import tree as T
from ..dist.collectives import shard_dims
from ..models.config import ModelConfig
from ..models.lm import LM, Runtime, requires_grad
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


def make_train_step(model, opt: AdamW):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    info)`` for an ``LM`` or an ``EncDec``: params and state updated in
    place and returned, ``info`` ``{"loss", "grad_norm", "lr"}`` as 0-d
    tensors.  batch: ``{"tokens", "labels"[, "prefix_embeds" | "frames"]}``
    on the model's device (a vision config's prefix embeddings, an
    encoder-decoder's frames)."""
    def train_step(params, opt_state, batch):
        requires_grad(params)
        loss = model.loss(params, batch)
        loss.backward()
        info = opt.update(params, [p.grad for p in T.leaves(params)],
                          opt_state)
        for p in T.leaves(params):
            p.grad = None
        info["loss"] = loss.detach()
        return params, opt_state, info
    return train_step


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
