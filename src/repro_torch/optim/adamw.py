"""AdamW with f32 master weights + cosine LR schedule + global-norm
clipping — the port of the JAX package's ``repro.optim.adamw``, with
its arithmetic in its order.

Optimizer state mirrors the parameter tree leaf for leaf:
``{"step", "m", "v", "master"}``, ``step`` a 0-d int32 tensor on the
parameters' device (so a checkpoint carries it and the schedule reads
it without a host sync).  Where the JAX optimizer returns new trees,
``AdamW.update`` writes the state and each parameter IN PLACE (the
model's tensors keep their identity) and returns only the step's
``{"grad_norm", "lr"}``.  It walks the leaves one at a time, so its
temporaries are a few copies of the largest leaf, not of the tree.

On a mesh each rank holds its shards of the parameters, gradients and
state: ``update`` takes the leaves' layouts and the mesh, and the
global norm sums the squares over the ranks, each leaf over the mesh
dims it is sharded on only, so that a replicated leaf counts once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from .. import tree as T


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def global_norm(tree, layouts: Optional[Sequence] = None,
                mesh=None) -> torch.Tensor:
    """The 2-norm of every leaf of ``tree`` together.  With ``layouts``
    (one per leaf, in leaf order) on ``mesh``, the leaves are this
    rank's shards: each leaf's squares are summed over the ranks of the
    mesh dims its layout shards it on, and over no other (a leaf
    replicated on a dim holds the same values on each of its ranks)."""
    leaves = T.leaves(tree)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
    from ..dist.collectives import axis, layout_dims
    groups: dict[tuple, torch.Tensor] = {}
    for g, lay in zip(leaves, layouts):
        key = tuple(sorted(set(layout_dims(lay))))
        sq = torch.sum(torch.square(g.float()))
        groups[key] = groups[key] + sq if key in groups else sq
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for dims, sq in sorted(groups.items()):
        for n in dims:
            ax = axis(mesh, n)
            if ax is not None:
                sq = ax.all_reduce(sq)
        total = total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The JAX package's clip of one leaf: scaled in f32, cast back to
    the gradient's type."""
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return T.map_tree(lambda g: _clipped(g, scale), tree), norm


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> dict:
        f32_zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
        return {
            "step": torch.zeros((), dtype=torch.int32,
                                device=T.leaves(params)[0].device),
            "m": T.map_tree(f32_zeros, params),
            "v": T.map_tree(f32_zeros, params),
            # an explicit copy: for f32 params .float() is the same tensor
            "master": T.map_tree(
                lambda p: p.detach().to(torch.float32, copy=True), params),
        }

    def abstract_state(self, abstract_params) -> dict:
        """``init``'s state of the ``meta`` tree ``abstract_params``
        (``LM.abstract_params``, or one rank's blocks of it): ``meta``
        tensors of its shapes and types."""
        if any(p.device.type != "meta" for p in T.leaves(abstract_params)):
            raise ValueError("abstract_state takes meta tensors")
        return self.init(abstract_params)

    @staticmethod
    def state_specs(param_specs) -> dict:
        """The state's layouts: the moments and master weights as their
        params, the step whole."""
        return {"step": (), "m": param_specs, "v": param_specs,
                "master": param_specs}

    @torch.no_grad()
    def update(self, params, grads, state, layouts: Optional[Sequence] = None,
               mesh=None) -> dict[str, torch.Tensor]:
        """One step: clip ``grads`` (a tree, or a list of the leaves, in
        ``params``' leaf order) by their global norm, then the AdamW
        update of ``state`` and ``params`` in place.  On a ``mesh`` the
        leaves are this rank's shards, laid out as ``layouts`` (one per
        leaf), and the norm is the whole tree's (``global_norm``).
        Returns the pre-clip ``grad_norm`` and the step's ``lr`` (0-d
        tensors)."""
        flat_g = T.leaves(grads)
        gnorm = global_norm(flat_g, layouts, mesh)
        scale = _clip_scale(gnorm, self.clip_norm)
        state["step"].add_(1)
        lr = self.lr(state["step"])
        step = state["step"].to(torch.float32)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step
        for p, g, m, v, w in zip(T.leaves(params), flat_g,
                                 T.leaves(state["m"]), T.leaves(state["v"]),
                                 T.leaves(state["master"])):
            g = _clipped(g, scale).float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            upd.add_(w, alpha=self.weight_decay)
            w.sub_(upd.mul_(lr))
            p.copy_(w)
        return {"grad_norm": gnorm, "lr": lr}
