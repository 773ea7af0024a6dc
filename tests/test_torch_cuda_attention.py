"""K4 ``flash_attention`` against its plain version, and the LM on the card.

Every test here is marked ``cuda`` and skips where there is no GPU. This
file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda*.py

Tolerances: float32 at atol 2e-5 (tests/test_kernels_pallas.py), both
sides IEEE float32. bfloat16 compared in float32: the kernel runs on the
tensor cores and rounds each softmax weight p_ij to bf16 for P·V (l_i sums
the unrounded weights), which moves a weight by at most 2^-8 of itself
(bf16's unit roundoff) and so an output o_id by at most
2^-8·Σ_j p_ij|v_jd|/l_i, the plain version on (q, k, |v|); the output then
rounds to bf16 once on each side, one bf16 spacing (at most 2^-7 of the
value) apart. So, element by element, atol 2e-5 + 2^-8·plain(q, k, |v|)
and rtol 2^-7.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_common import cuda  # noqa: F401

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import ops, ref
from repro_torch.models import decode_step, forward, init_decode_state, \
    init_model
from repro_torch.runtime import Request, ServeEngine

def _assert_k4_close(got, q, k, v, causal=True, window=0, msg=""):
    """K4's output against its plain version under q's dtype's tolerance."""
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5, msg=msg)
        return
    want = want.float()
    moved = ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                    causal=causal, window=window)
    tol = 2e-5 + 2.0 ** -8 * moved + 2.0 ** -7 * want.abs()
    share = float(((got.float() - want).abs() / tol).max())
    assert share <= 1, f"{msg}: {share:.3f} of the tolerance"


# (hq, hkv, causal, window): the GQA / mask cells of
# tests/test_kernels_pallas.py
CELLS = [(8, 2, True, 0), (4, 1, True, 64), (8, 8, False, 0)]


def _qkv(b, hq, hkv, s, d, seed, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((b, h, s, d), generator=g, device="cuda").to(
        dtype) for h in (hq, hkv, hkv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,causal,window", CELLS)
def test_k4_matches_plain(cuda, dtype, hq, hkv, causal, window):
    """Ragged S ≤ 256 (32, 96) and the 256-multiples, D ∈ {32, 64, 128}."""
    for s in (32, 96, 256, 512):
        for d in (32, 64, 128):
            q, k, v = _qkv(2, hq, hkv, s, d, seed=s + d, dtype=dtype)
            got = ops.attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == q.shape
            _assert_k4_close(got, q, k, v, causal, window, msg=f"S={s} D={d}")


@pytest.mark.cuda
def test_k4_bf16_at_the_prefill_head_shape(cuda):
    """phi4-mini's heads (24 query, 8 KV, D = 128), causal, S = 2,048."""
    q, k, v = _qkv(1, 24, 8, 2048, 128, seed=11, dtype=torch.bfloat16)
    got = ops.attention(q, k, v)
    torch.cuda.synchronize()
    _assert_k4_close(got, q, k, v)


@pytest.mark.cuda
def test_k4_counts_its_launches_and_cpu_tensors_take_none(cuda):
    q, k, v = _qkv(1, 4, 2, 96, 64, seed=1, dtype=torch.float32)
    ops.reset_launch_counts()
    ops.attention(q, k, v)
    ops.attention(q, k, v, causal=False, scale=0.5)
    assert ops.launch_counts()["flash_attention"] == 2
    ops.attention(q.cpu(), k.cpu(), v.cpu())
    assert ops.launch_counts()["flash_attention"] == 2


@pytest.mark.cuda
def test_k4_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 2, 1, 300, 32, seed=2, dtype=torch.float32)
    with pytest.raises(ValueError, match="S=300"):
        k4.flash_attention(q, k, v)
    q, k, v = _qkv(1, 2, 1, 64, 32, seed=3, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k4.flash_attention(q, k, v)
    q, k, v = _qkv(1, 2, 1, 64, 48, seed=4, dtype=torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        k4.flash_attention(q, k, v)
    q, k, v = _qkv(1, 3, 2, 64, 32, seed=5, dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        k4.flash_attention(q, k, v)
    # bf16 goes through TMA, which needs 16-byte aligned operands
    flat = torch.zeros(2 * 64 * 32 + 1, device="cuda", dtype=torch.bfloat16)
    q = flat[1:].view(1, 2, 64, 32)
    with pytest.raises(ValueError, match="16-byte"):
        k4.flash_attention(q, q, q)


@pytest.mark.cuda
def test_k4_refuses_operands_that_require_grad(cuda):
    """The wrapper is the forward alone: gradients go through
    ``ops.attention`` (tests/test_torch_cuda_train.py)."""
    q, k, v = _qkv(1, 2, 1, 64, 32, seed=6, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="ops.attention"):
        k4.flash_attention(q.requires_grad_(), k, v)


def _cpu(tree):
    """A copy of a parameter tree (dicts and lists of tensors) on the CPU."""
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return tree.cpu()


def _small(name: str):
    return dataclasses.replace(
        get_config(name), n_layers=4, d_model=128, vocab_size=512,
        vocab_pad_multiple=128, dtype="float32", n_heads=4, n_kv_heads=1,
        d_ff=256, head_dim=32, use_pallas=True)


@pytest.mark.cuda
def test_forward_on_the_card_launches_k4_per_layer(cuda):
    """A small phi4-mini forward through K4 (one launch per layer) gives the
    CPU forward's logits; decode steps give the forward's last logits."""
    cfg = _small("phi4-mini-3.8b")
    params = init_model(cfg, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 96)), dtype=torch.int32)
    ops.reset_launch_counts()
    got = forward(params, cfg, toks.cuda()).logits
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    want = forward(_cpu(params), cfg, toks).logits
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    st = init_decode_state(cfg, 2, 128, device="cuda")
    for i in range(96):
        lg, st = decode_step(params, cfg, toks[:, i:i + 1].cuda(), st)
    torch.testing.assert_close(lg[:, 0], got[:, -1], rtol=0, atol=2e-2)


@pytest.mark.cuda
def test_serve_engine_on_the_card(cuda):
    cfg = _small("chatglm3-6b")
    engine = ServeEngine(cfg, init_model(cfg, device="cuda"), slots=2,
                         max_len=64)
    rng = np.random.default_rng(1)
    for uid in range(3):
        engine.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, 5).astype(np.int32), max_new_tokens=4))
    done = engine.run()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert all(len(r.generated) == 4 for r in done)
