"""Model/config system: one dataclass covers every assigned architecture.

The port's own copy of the reference's ``configs/base.py``: every
architecture file in this package instantiates ``ModelConfig`` with the
exact published shape and registers it under its id, and ``--arch <id>``
resolves through ``get_config``. ``act_dtype`` is a ``torch.dtype``.
``use_pallas`` keeps its name: in the port it routes exact attention
through the attention kernel (K4 ``flash_attention`` on CUDA tensors, its
plain version on CPU ones). ``param_dtype`` is the dtype training holds
its master weights in (each weight is cast to ``dtype`` where it is used);
``remat`` is the per-layer rematerialisation of ``models.transformer``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.precision import to_dtype


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0           # routed experts
    top_k: int = 1
    n_shared: int = 0            # always-on shared experts
    d_ff_expert: int = 0         # per-expert hidden
    d_ff_shared: int = 0         # total shared hidden
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    first_dense_ff: int = 0      # deepseek: layer 0 is a dense FFN


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    expand: int = 2
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    rotary_frac: float = 1.0
    norm_eps: float = 1e-5
    activation: str = "silu"
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    local_window: int = 0        # >0 with alt_local: gemma2-style alternation
    alt_local: bool = False
    post_norms: bool = False     # gemma2: post-attn/post-ffn RMSNorms
    tie_embeddings: bool = True
    vocab_pad_multiple: int = 2048   # pads so model-axis (16) shards divide
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    shared_attn_every: int = 0   # zamba2: shared attn block every k layers
    modality: str = "text"       # text | vision | audio
    num_codebooks: int = 1       # musicgen parallel codebook heads
    # --- paper technique integration ---
    attn_approx: str = "none"    # none | nystrom_rls
    nystrom_landmarks: int = 512
    rls_keep_recent: int = 128   # pinned recency window in KV compression
    # --- execution ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"  # training's master weights
    use_pallas: bool = False     # exact attention through K4 (plain on CPU)
    remat: str = "dots"          # none | dots | full

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def act_dtype(self) -> torch.dtype:
        return to_dtype(self.dtype)

    def n_params(self) -> int:
        """Total parameter count (used for 6·N·D roofline bookkeeping)."""
        return _count_params(self)

    def n_active_params(self) -> int:
        """Active-per-token parameters (MoE: top_k + shared only)."""
        return _count_params(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    dh = cfg.resolved_head_dim
    q = cfg.d_model * cfg.n_heads * dh
    kv = 2 * cfg.d_model * cfg.n_kv_heads * dh
    o = cfg.n_heads * dh * cfg.d_model
    return q + kv + o


def _count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    emb = cfg.padded_vocab * d
    total = emb if cfg.tie_embeddings else 2 * emb
    glu = 3  # all assigned archs use gated MLPs
    if cfg.family in ("dense", "vlm", "audio"):
        per = _attn_params(cfg) + glu * d * cfg.d_ff + 2 * d
        total += cfg.n_layers * per
    elif cfg.family == "moe":
        m = cfg.moe
        routed_all = m.n_experts * glu * d * m.d_ff_expert
        routed_act = m.top_k * glu * d * m.d_ff_expert
        shared = glu * d * m.d_ff_shared
        router = d * m.n_experts
        n_moe = cfg.n_layers - (1 if m.first_dense_ff else 0)
        per_moe = _attn_params(cfg) + shared + router + 2 * d \
            + (routed_act if active_only else routed_all)
        total += n_moe * per_moe
        if m.first_dense_ff:
            total += _attn_params(cfg) + glu * d * m.first_dense_ff + 2 * d
    elif cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        proj_in = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
        conv = (d_in + 2 * s.n_groups * s.d_state) * s.conv_kernel
        per = proj_in + conv + d_in * d + 2 * nh + d_in + 2 * d
        total += cfg.n_layers * per
        if cfg.family == "hybrid" and cfg.shared_attn_every:
            total += _attn_params(cfg) + glu * d * cfg.d_ff + 2 * d
    return total


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, **overrides) -> ModelConfig:
    from . import ALL_ARCHS  # noqa: F401 — force registration
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_archs() -> list[str]:
    from . import ALL_ARCHS  # noqa: F401
    return sorted(_REGISTRY)
