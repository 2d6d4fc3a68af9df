"""Carry the JAX package's ``LM.init_params`` weights into the port."""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .lm import layer_kinds

# leaves of two or more dims that stay f32, as in the JAX package
_F32 = ("router", "conv_w")


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a)                      # a writable host copy
    if a.dtype.name == "bfloat16":       # torch reads no numpy bf16:
        a = a.astype(np.float32)         # widen exactly, narrow below
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def params_from_jax(np_params: dict, cfg: ModelConfig,
                    device="cpu") -> dict:
    """The port's parameter dict from the JAX parameter tree passed
    through numpy (``jax.tree.map(np.asarray, params)``).

    The stack ``stack["b{i}_{kind}"]`` holds pattern position ``i``'s
    layers with a leading ``n_super`` axis (the JAX model scans over
    it); it is unstacked and interleaved into one dict per layer —
    b0[j], b1[j], ... for each super-block j — followed by the unscanned
    ``tail`` layers, the order of ``lm.layer_kinds(cfg)``, which the
    stack's kinds are checked against (an MoE layer's experts keep
    their leading E axis).  Matrices keep the config dtype; norm scales,
    the RG-LRU's ``lam`` and ``conv_w`` and the MoE router stay f32 as
    in the JAX package.  ``lm_head`` is read only where the JAX tree has
    one (tied embeddings have none)."""
    dt = getattr(torch, cfg.dtype)

    def conv(tree):
        return {k: (conv(v) if isinstance(v, dict) else
                    _tensor(v, dt if np.ndim(v) >= 2 and k not in _F32
                            else torch.float32, device))
                for k, v in tree.items()}

    stack = np_params["stack"]
    names = sorted(stack, key=lambda n: int(n.split("_")[0][1:]))
    n_super = np.shape(stack[names[0]]["ln1"]["w"])[0]

    def layer(j, tree):
        return {k: (layer(j, v) if isinstance(v, dict) else v[j])
                for k, v in tree.items()}

    layers = [conv(layer(j, stack[n])) for j in range(n_super)
              for n in names]
    layers += [conv(t) for t in np_params["tail"]]
    kinds = ["rglru" if "lam" in p["mix"] else "attn" for p in layers]
    if kinds != layer_kinds(cfg):
        raise ValueError(f"the JAX tree's layers {kinds} are not the "
                         f"config's {layer_kinds(cfg)}")
    out = {
        "embed": _tensor(np_params["embed"], dt, device),
        "final_norm": {"w": _tensor(np_params["final_norm"]["w"],
                                    torch.float32, device)},
    }
    if "lm_head" in np_params:
        out["lm_head"] = _tensor(np_params["lm_head"], dt, device)
    out["layers"] = layers
    return out
