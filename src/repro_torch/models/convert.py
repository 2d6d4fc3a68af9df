"""Carry the JAX package's ``LM.init_params`` weights into the port."""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a)                      # a writable host copy
    if a.dtype.name == "bfloat16":       # torch reads no numpy bf16:
        a = a.astype(np.float32)         # widen exactly, narrow below
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def params_from_jax(np_params: dict, cfg: ModelConfig,
                    device="cpu") -> dict:
    """The port's parameter dict from the JAX parameter tree passed
    through numpy (``jax.tree.map(np.asarray, params)``).

    The dense stack ``stack["b0_attn"]`` carries a leading ``n_super``
    axis (the JAX model scans over it); it is unstacked into one dict
    per layer, followed by the unscanned ``tail`` layers (an MoE
    layer's experts keep their leading E axis).  Matrices keep the
    config dtype; norm scales and the MoE router stay f32 as in the JAX
    package."""
    dt = getattr(torch, cfg.dtype)

    def conv(tree):
        return {k: (conv(v) if isinstance(v, dict) else
                    _tensor(v, dt if np.ndim(v) >= 2 and k != "router"
                            else torch.float32, device))
                for k, v in tree.items()}

    stack = np_params["stack"]
    if set(stack) != {"b0_attn"}:
        raise ValueError(f"not a dense attention stack: {sorted(stack)}")
    stacked = stack["b0_attn"]
    n_super = np.shape(stacked["ln1"]["w"])[0]

    def layer(i, tree):
        return {k: (layer(i, v) if isinstance(v, dict) else v[i])
                for k, v in tree.items()}

    layers = [conv(layer(i, stacked)) for i in range(n_super)]
    layers += [conv(t) for t in np_params["tail"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a {cfg.n_layers}-layer "
                         f"config")
    return {
        "embed": _tensor(np_params["embed"], dt, device),
        "final_norm": {"w": _tensor(np_params["final_norm"]["w"],
                                    torch.float32, device)},
        "lm_head": _tensor(np_params["lm_head"], dt, device),
        "layers": layers,
    }
