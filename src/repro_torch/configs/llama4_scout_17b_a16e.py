"""llama4-scout-17b-a16e — MoE 16e top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 (per expert) vocab=202048,
16 routed experts top-1 + 1 shared expert (8192 hidden).
"""
from .base import ModelConfig, MoEConfig, register


@register("llama4-scout-17b-a16e")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        rope_theta=500_000.0,
        activation="silu",
        tie_embeddings=False,
        moe=MoEConfig(n_experts=16, top_k=1, n_shared=1, d_ff_expert=8192,
                      d_ff_shared=8192, capacity_factor=1.25),
        nystrom_landmarks=1024,
    )
