"""chatglm3-6b — dense, RoPE-2d (partial rotary), extreme GQA [arXiv:2406.12793].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
ChatGLM applies rotary to half of each head dim ("2d RoPE") — rotary_frac=0.5.
"""
from .base import ModelConfig, register


@register("chatglm3-6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13_696,
        vocab_size=65_024,
        rotary_frac=0.5,
        activation="silu",
        tie_embeddings=False,
        nystrom_landmarks=1024,
    )
