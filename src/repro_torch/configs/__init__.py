"""Architecture registry.

Every ported architecture has a module ``<id>.py`` exposing FULL (the
published config) and SMOKE (a reduced same-family config for CPU
tests).  ``get_config(name, smoke=...)`` resolves either.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = ["qwen3_8b"]

# CLI ids (--arch) use dashes
ALIASES = {"qwen3-8b": "qwen3_8b"}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise ValueError(f"unknown or unported architecture {name!r}; "
                         f"ported: {ARCHS}")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.SMOKE if smoke else mod.FULL
