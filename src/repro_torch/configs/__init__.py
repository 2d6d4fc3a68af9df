"""Architecture registry.

Every ported architecture has a module ``<id>.py`` exposing FULL (the
published config) and SMOKE (a reduced same-family config for CPU
tests).  ``get_config(name, smoke=...)`` resolves either.
"""
from __future__ import annotations

import importlib

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
