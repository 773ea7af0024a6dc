"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048, 4 parallel codebook
heads (delay pattern). The EnCodec frontend is a STUB: ``input_specs()``
provides precomputed frame embeddings; the output head projects to
(s, num_codebooks, 2048).
"""
from .base import ModelConfig, register


@register("musicgen-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        activation="gelu",
        tie_embeddings=False,
        modality="audio",
        num_codebooks=4,
        vocab_pad_multiple=128,
        nystrom_landmarks=512,
    )
