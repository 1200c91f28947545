"""Architecture registry: --arch <id> -> ModelConfig (full) / smoke config."""
from __future__ import annotations

import importlib

ARCHS = [
    "deepseek_v3_671b", "phi35_moe_42b", "olmo_1b", "phi4_mini_3p8b",
    "llama3_405b", "stablelm_3b", "internvl2_26b", "seamless_m4t_large_v2",
    "jamba_v01_52b", "xlstm_350m",
    # paper-native configs (graph engine):
    "drone_graph",
]

_ALIASES = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "olmo-1b": "olmo_1b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "llama3-405b": "llama3_405b",
    "stablelm-3b": "stablelm_3b",
    "internvl2-26b": "internvl2_26b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "xlstm-350m": "xlstm_350m",
}


def _module(arch: str):
    arch = _ALIASES.get(arch, arch).replace("-", "_")
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch}; know {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
