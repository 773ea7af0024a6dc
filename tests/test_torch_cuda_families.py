"""K4 at zamba2's head dim 112, and the moe, hybrid and audio families on
the card against the port on the CPU.

Every test here is marked ``cuda`` and skips where there is no GPU. This
file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda*.py

K4's tolerances are tests/test_torch_cuda_attention.py's: float32 at atol
2e-5; bfloat16 element by element, atol 2e-5 + 2^-8·plain(q, k, |v|) and
rtol 2^-7 (P rounded to bf16 for P·V, the output rounded once on each
side). The models run in float32 at the JAX smoke tests' reduction
(d_model 128, 4 heads of 32; 8 experts top-2; d_state 16, chunk 32;
zamba2 at 7 layers, the shared block every 3 with 2 heads of 112): the
card's forward (K4's SIMT instance) against the CPU's (its plain
version) within atol 1e-4, the CPU tests' tolerance against the JAX
package, as both sum in different orders.
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


def _qkv(b, hq, hkv, s, d, seed, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((b, h, s, d), generator=g, device="cuda").to(
        dtype) for h in (hq, hkv, hkv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,causal,window", [
    (8, 2, True, 0), (8, 2, True, 64), (8, 8, False, 0)])
def test_k4_head_dim_112_matches_plain(cuda, dtype, hq, hkv, causal, window):
    """D = 112 (the bf16 instance runs the 128 tiles over the real rows):
    ragged S ≤ 256 and the 256-multiples, GQA and MHA, the three masks."""
    assert 112 in k4.HEAD_DIMS
    for s in (32, 96, 256, 512):
        q, k, v = _qkv(2, hq, hkv, s, 112, seed=s, dtype=dtype)
        got = ops.attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        assert got.stride() == q.stride()
        _assert_k4_close(got, q, k, v, causal, window, msg=f"S={s}")


@pytest.mark.cuda
def test_k4_head_dim_112_at_zamba2_heads(cuda):
    """zamba2-7b's shared attention: 32 heads of 112, causal, S = 2,048,
    bfloat16; the output's padded columns are never written past 112."""
    q, k, v = _qkv(1, 32, 32, 2048, 112, seed=12, dtype=torch.bfloat16)
    got = ops.attention(q, k, v)
    torch.cuda.synchronize()
    _assert_k4_close(got, q, k, v)


def _small(name: str):
    """The JAX smoke tests' reduction (tests/test_models_smoke.py), with
    K4 on."""
    cfg = get_config(name)
    reps = dict(n_layers=4, d_model=128, vocab_size=512,
                vocab_pad_multiple=128, dtype="float32", use_pallas=True)
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        reps.update(n_heads=4,
                    n_kv_heads=max(1, cfg.n_kv_heads * 4 // cfg.n_heads),
                    d_ff=256, head_dim=32)
    if cfg.family == "moe":
        reps["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64, d_ff_shared=128,
            first_dense_ff=256 if cfg.moe.first_dense_ff else 0)
    if cfg.family in ("ssm", "hybrid"):
        reps["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32,
                                          chunk=32)
    if cfg.family == "hybrid":
        # the smoke reduction keeps 32 heads (of 4) at d_model 128; here
        # the shared block takes zamba2's head dim, 112, so that K4 runs it
        reps.update(n_layers=7, shared_attn_every=3, n_heads=2,
                    n_kv_heads=2, head_dim=112)
    return dataclasses.replace(cfg, **reps)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return tree.cpu()


def _inputs(cfg, b: int, s: int, seed: int) -> dict:
    g = np.random.default_rng(seed)
    if cfg.modality in ("vision", "audio"):
        return {"embeds": torch.as_tensor(g.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32))}
    return {"tokens": torch.as_tensor(g.integers(0, cfg.vocab_size, (b, s)),
                                      dtype=torch.int32)}


# K4 launches a prefill: every layer's attention (deepseek's layer0
# included), one a use of zamba2's shared block, every musicgen layer
LAUNCHES = {"deepseek-moe-16b": 4, "zamba2-7b": 2, "musicgen-medium": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_forward_on_the_card_matches_the_cpu(cuda, name):
    cfg = _small(name)
    params = init_model(cfg, device="cuda")
    x = _inputs(cfg, 2, 64, seed=0)
    ops.reset_launch_counts()
    got = forward(params, cfg, **{k: v.cuda() for k, v in x.items()})
    assert ops.launch_counts()["flash_attention"] == LAUNCHES[name]
    want = forward(_cpu(params), cfg, **x)
    torch.testing.assert_close(got.logits.cpu(), want.logits, rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(got.aux_loss.cpu(), want.aux_loss, rtol=1e-5,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_decode_steps_on_the_card_match_the_cpu(cuda, name):
    """8 decode steps of batch 2 on both devices (the SSM states and KV
    caches updated in place on each)."""
    cfg = _small(name)
    params = init_model(cfg, device="cuda")
    host = _cpu(params)
    x = _inputs(cfg, 2, 8, seed=1)
    key = next(iter(x))
    st = init_decode_state(cfg, 2, 16, device="cuda")
    hst = init_decode_state(cfg, 2, 16, device="cpu")
    for i in range(8):
        step = {key: x[key][:, i:i + 1]}
        if key == "embeds":
            step["tokens"] = None
        lg, st = decode_step(params, cfg, state=st,
                             **{k: None if v is None else v.cuda()
                                for k, v in step.items()})
        hlg, hst = decode_step(host, cfg, state=hst, **step)
        torch.testing.assert_close(lg.cpu(), hlg, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_reused_slot_on_the_card_generates_the_same_tokens(cuda):
    """One slot, one prompt twice through zamba2's engine on the card."""
    cfg = _small("zamba2-7b")
    engine = ServeEngine(cfg, init_model(cfg, device="cuda"), slots=1,
                         max_len=64)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 6).astype(
        np.int32)
    for uid in (0, 1):
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=6))
    done = {r.uid: r.generated for r in engine.run()}
    assert done[0] == done[1] and len(done[0]) == 6
