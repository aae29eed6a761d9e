"""Architecture registry: ``--arch <id>`` resolution.

The same ten architectures as ``repro.configs``, full and smoke, and
beside them the synthetic ``synth_*`` graphs of the compiler's graph
generator (``repro_torch.core.generate``), as the reference registers
them.
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, ShapeSpec, shape_applicable
from ..core.generate import SYNTH_CONFIGS, get_synth, list_synths

_ARCH_MODULES = {
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "xlstm-125m": "xlstm_125m",
    "musicgen-large": "musicgen_large",
    "smollm-135m": "smollm_135m",
    "stablelm-3b": "stablelm_3b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "smollm-360m": "smollm_360m",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-v3-671b": "deepseek_v3_671b",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return mod.smoke_config() if smoke else mod.config()


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "shape_applicable",
           "get_config", "list_archs",
           # Synthetic scale-stress graphs ride the same registry so
           # benches and tests resolve them next to the real archs.
           "SYNTH_CONFIGS", "get_synth", "list_synths"]
