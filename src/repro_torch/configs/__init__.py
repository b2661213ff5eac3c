"""Architecture registry of the port: the dense attention-only configs.

Each ``<arch>.py`` exposes ``CONFIG``; ``get_config(name)`` resolves by
registry id (the ``--arch`` flag of the launcher).  The hybrid, MoE,
encoder and VLM configs of the reference registry are not ported yet.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_REGISTRY: Dict[str, str] = {
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    # the paper's own evaluation models
    "llama2-7b": "repro_torch.configs.llama2_7b",
    "llama3.1-8b": "repro_torch.configs.llama3_1_8b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[name]).CONFIG


def list_archs() -> List[str]:
    return list(_REGISTRY)
