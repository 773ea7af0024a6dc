"""gemma2-2b — local+global alternating attention, logit softcaps [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, head_dim=256,
sliding window 4096 on even layers, attn softcap 50, final logit softcap 30.
"""
from .base import ModelConfig, register


@register("gemma2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256_000,
        activation="gelu_tanh",
        attn_softcap=50.0,
        final_softcap=30.0,
        local_window=4096,
        alt_local=True,
        post_norms=True,
        tie_embeddings=True,
        nystrom_landmarks=1024,
    )
