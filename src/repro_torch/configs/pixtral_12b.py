"""pixtral-12b — pixtral-ViT frontend + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409].

Backbone: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
The vision frontend is a STUB per the assignment: ``input_specs()`` feeds
precomputed patch embeddings (b, s, d_model) directly into the backbone.
"""
from .base import ModelConfig, register


@register("pixtral-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        vocab_size=131_072,
        rope_theta=1_000_000.0,
        activation="silu",
        tie_embeddings=False,
        modality="vision",
        nystrom_landmarks=1024,
    )
