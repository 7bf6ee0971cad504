"""Assigned-architecture configs.  ``get(name)`` returns the full
(paper-exact) ModelConfig; ``get_smoke(name)`` returns a reduced config of
the same family for CPU smoke tests."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

ARCHS: List[str] = [
    "phi3_medium_14b",
    "glm4_9b",
    "deepseek_coder_33b",
    "qwen3_4b",
    "seamless_m4t_medium",
    "xlstm_1_3b",
    "moonshot_v1_16b_a3b",
    "olmoe_1b_7b",
    "pixtral_12b",
    "recurrentgemma_9b",
]

# canonical dashed ids (as given in the assignment) -> module names
ALIASES: Dict[str, str] = {
    "phi3-medium-14b": "phi3_medium_14b",
    "glm4-9b": "glm4_9b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-4b": "qwen3_4b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "xlstm-1.3b": "xlstm_1_3b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "pixtral-12b": "pixtral_12b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def _norm(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.CONFIG


def get_smoke(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCHS}
