"""Architecture registry and the input-shape cells.

Every ported architecture has a module ``<id>.py`` exposing FULL (the
published config) and SMOKE (a reduced same-family config for CPU
tests).  ``get_config(name, smoke=...)`` resolves either.  ``SHAPES``
are the JAX package's four cells, ``cell_applicable`` its skip rule
and ``all_cells`` the (arch, shape) pairs that apply.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from ..models.config import ModelConfig

ARCHS = ["qwen3_8b", "granite_20b", "codeqwen15_7b", "granite_34b",
         "olmoe_1b_7b", "mixtral_8x7b", "pixtral_12b", "recurrentgemma_2b",
         "mamba2_1p3b", "whisper_small"]

# CLI ids (--arch) use dashes
ALIASES = {"qwen3-8b": "qwen3_8b", "granite-20b": "granite_20b",
           "codeqwen1.5-7b": "codeqwen15_7b", "granite-34b": "granite_34b",
           "olmoe-1b-7b": "olmoe_1b_7b", "mixtral-8x7b": "mixtral_8x7b",
           "pixtral-12b": "pixtral_12b",
           "recurrentgemma-2b": "recurrentgemma_2b",
           "mamba2-1.3b": "mamba2_1p3b", "whisper-small": "whisper_small"}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise ValueError(f"unknown or unported architecture {name!r}; "
                         f"ported: {ARCHS}")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.SMOKE if smoke else mod.FULL


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str       # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """The JAX package's skip rule: only a sub-quadratic arch decodes at
    500k."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch cannot decode at 500k (skip)"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    out = []
    for a in ARCHS:
        cfg = get_config(a)
        for s in SHAPES.values():
            if cell_applicable(cfg, s)[0]:
                out.append((a, s.name))
    return out
