"""Registry of the ten assigned architectures (exact published configs)."""
from __future__ import annotations

from .base import ArchConfig
from .zamba2_1p2b import CONFIG as zamba2_1p2b
from .smollm_360m import CONFIG as smollm_360m
from .tinyllama_1p1b import CONFIG as tinyllama_1p1b
from .qwen2_1p5b import CONFIG as qwen2_1p5b
from .llama3_8b import CONFIG as llama3_8b
from .xlstm_1p3b import CONFIG as xlstm_1p3b
from .whisper_large_v3 import CONFIG as whisper_large_v3
from .llama32_vision_11b import CONFIG as llama32_vision_11b
from .deepseek_v2_lite_16b import CONFIG as deepseek_v2_lite_16b
from .llama4_maverick_400b import CONFIG as llama4_maverick_400b

ARCHS = {
    c.name: c
    for c in [
        zamba2_1p2b,
        smollm_360m,
        tinyllama_1p1b,
        qwen2_1p5b,
        llama3_8b,
        xlstm_1p3b,
        whisper_large_v3,
        llama32_vision_11b,
        deepseek_v2_lite_16b,
        llama4_maverick_400b,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
