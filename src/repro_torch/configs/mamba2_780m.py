"""mamba2-780m — SSD state-space model [arXiv:2405.21060].

48L, d_model=1536, attention-free, vocab 50280, ssm_state=128.
d_inner = 2·1536 = 3072, head_dim 64 → 48 SSM heads. The paper's attention
technique is inapplicable (no Gram matrix) — see DESIGN.md §Arch-applicability.
"""
from .base import ModelConfig, SSMConfig, register


@register("mamba2-780m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50_280,
        ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, conv_kernel=4,
                      expand=2, chunk=256),
        tie_embeddings=True,
        attn_approx="none",  # inapplicable: attention-free architecture
    )
