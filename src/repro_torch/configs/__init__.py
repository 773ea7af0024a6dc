"""Architecture registry: the ten LM architectures the repo defines."""
from .base import ModelConfig, MoEConfig, SSMConfig, get_config, list_archs

from . import (mamba2_780m, zamba2_7b, chatglm3_6b, phi4_mini_3_8b,
               mistral_nemo_12b, gemma2_2b, pixtral_12b, musicgen_medium,
               deepseek_moe_16b, llama4_scout_17b_a16e)

ALL_ARCHS = [
    "mamba2-780m", "zamba2-7b", "chatglm3-6b", "phi4-mini-3.8b",
    "mistral-nemo-12b", "gemma2-2b", "pixtral-12b", "musicgen-medium",
    "deepseek-moe-16b", "llama4-scout-17b-a16e",
]

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "get_config",
           "list_archs", "ALL_ARCHS"]
