"""Architecture registry of the port: the reference's twelve configs --
the ten assigned archs and the paper's own two models.

Each ``<arch>.py`` exposes ``CONFIG``; ``get_config(name)`` resolves by
registry id (the ``--arch`` flag of the launcher).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_REGISTRY: Dict[str, str] = {
    # assigned pool
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    # the paper's own evaluation models
    "llama2-7b": "repro_torch.configs.llama2_7b",
    "llama3.1-8b": "repro_torch.configs.llama3_1_8b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[name]).CONFIG


def list_archs(assigned_only: bool = False) -> List[str]:
    names = list(_REGISTRY)
    if assigned_only:
        names = [n for n in names if n not in ("llama2-7b", "llama3.1-8b")]
    return names
