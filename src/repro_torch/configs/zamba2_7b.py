"""zamba2-7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81L d_model=3584, 32H MHA (kv=32) in the shared block, d_ff=14336,
vocab 32000, ssm_state=64. The single shared attention+MLP block is applied
every 6 mamba layers (Zamba2 interleaving, shared weights across uses).
"""
from .base import ModelConfig, SSMConfig, register


@register("zamba2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14_336,
        vocab_size=32_000,
        ssm=SSMConfig(d_state=64, head_dim=64, n_groups=2, conv_kernel=4,
                      expand=2, chunk=256),
        shared_attn_every=6,
        attn_approx="none",          # exact attn default; nystrom_rls optional
        nystrom_landmarks=1024,
    )
