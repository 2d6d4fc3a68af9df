"""Carry the JAX package's ``LM.init_params`` and ``EncDec.init_params``
weights into the port."""
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


def _conv(tree: dict, dt: torch.dtype, device) -> dict:
    """A numpy tree's leaves as tensors: matrices in ``dt``; vectors
    (norm scales and biases, the RG-LRU's ``lam``, the Mamba-2 block's
    ``A_log``, ``D``, ``dt_bias`` and ``norm_w``) and the ``_F32``
    matrices in f32, as in the JAX package."""
    return {k: (_conv(v, dt, device) if isinstance(v, dict) else
                _tensor(v, dt if np.ndim(v) >= 2 and k not in _F32
                        else torch.float32, device))
            for k, v in tree.items()}


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
    their leading E axis).  Matrices keep the config dtype (``_conv``).
    ``lm_head`` and ``pos_embed`` are read only where the JAX tree has
    them (tied embeddings have no head, rope no learned positions)."""
    dt = getattr(torch, cfg.dtype)
    stack = np_params["stack"]
    names = sorted(stack, key=lambda n: int(n.split("_")[0][1:]))
    n_super = np.shape(stack[names[0]]["ln1"]["w"])[0]

    layers = [_conv(_slice(stack[n], j), dt, device)
              for j in range(n_super) for n in names]
    layers += [_conv(t, dt, device) for t in np_params["tail"]]
    kinds = ["rglru" if "lam" in p["mix"] else
             "mamba" if "A_log" in p["mix"] else "attn" for p in layers]
    if kinds != layer_kinds(cfg):
        raise ValueError(f"the JAX tree's layers {kinds} are not the "
                         f"config's {layer_kinds(cfg)}")
    out = _conv({k: np_params[k] for k in ("embed", "final_norm",
                                           "pos_embed", "lm_head")
                 if k in np_params}, dt, device)
    out["layers"] = layers
    return out


def encdec_params_from_jax(np_params: dict, cfg: ModelConfig,
                           device="cpu") -> dict:
    """``models.whisper.EncDec``'s parameter dict from the JAX package's
    ``EncDec`` tree passed through numpy: ``enc_stack`` and
    ``dec_stack`` (a leading layer axis) unstacked into the lists
    ``enc_layers`` and ``dec_layers`` of per-layer dicts; ``enc_pos``,
    ``dec_pos`` and ``embed`` in the config dtype, the layernorms' ``w``
    and ``b`` in f32."""
    dt = getattr(torch, cfg.dtype)
    out = _conv({k: np_params[k] for k in ("enc_pos", "enc_norm", "embed",
                                           "dec_pos", "final_norm")},
                dt, device)
    for side, n in (("enc", cfg.encoder.n_layers), ("dec", cfg.n_layers)):
        out[f"{side}_layers"] = [_conv(_slice(np_params[f"{side}_stack"], j),
                                       dt, device) for j in range(n)]
    return out


def _slice(tree, j: int):
    """Entry ``j`` of every leaf's leading axis."""
    return {k: (_slice(v, j) if isinstance(v, dict) else v[j])
            for k, v in tree.items()}
