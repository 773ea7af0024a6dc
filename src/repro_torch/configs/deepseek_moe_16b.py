"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066].

28L d_model=2048 16H (MHA kv=16) per-expert d_ff=1408 vocab=102400.
Layer 0 is a dense FFN (d_ff = 10944); layers 1..27 are MoE. Shared experts:
2 × 1408 = 2816 hidden.
"""
from .base import ModelConfig, MoEConfig, register


@register("deepseek-moe-16b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=102_400,
        activation="silu",
        tie_embeddings=False,
        moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                      d_ff_shared=2816, capacity_factor=1.25,
                      first_dense_ff=10_944),
        nystrom_landmarks=1024,
    )
