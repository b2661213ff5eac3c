"""Architecture registry of the port: the dense Llama-family configs
and the Jamba hybrid.

Each ``<arch>.py`` exposes ``CONFIG``; ``get_config(name)`` resolves by
registry id (the ``--arch`` flag of the launcher).  Jamba's MoE FFN is
not ported yet (``models.check_supported`` says so); the other MoE,
xLSTM, encoder and VLM configs of the reference registry are not ported.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_REGISTRY: Dict[str, str] = {
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
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
