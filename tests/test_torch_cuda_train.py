"""Training on the card: K4 under autograd and the train step.

Every test here is marked ``cuda`` and skips where there is no GPU. This
file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda*.py

K4's Function: its forward launches K4 once and is held to K4's tolerance
(float32 atol 2e-5; bf16 element by element, atol 2e-5 +
2^-8·plain(q, k, |v|) and rtol 2^-7, as tests/test_torch_cuda_attention.py
sets out); its backward recomputes through ``ref.attention_ref``, so for
the same upstream gradient its gradients equal the plain version's
autograd bit for bit. The train step on the card against the same step on
the CPU (float32, a small phi4-mini through K4's SIMT instance): the two
sum in different orders (cuBLAS, K4's online softmax), so the loss is held
at rtol 1e-5 and the parameters after two steps at atol 1e-6; AdamW's eps
is 1e-3 there, because Adam divides each gradient by its own magnitude and
with eps = 1e-8 an element whose gradient is at the level of the rounding
differences moves by a good part of a step in either run.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_common import cuda  # noqa: F401
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import LMDataConfig, lm_batch
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import build_small_cfg, make_driver
from repro_torch.models import init_model, loss_fn
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import StepFailure, init_train_state, \
    make_train_step

CELLS = [(8, 2, True, 0), (4, 1, True, 64), (8, 8, False, 0)]


def _qkv(b, hq, hkv, s, d, seed, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((b, h, s, d), generator=g, device="cuda").to(
        dtype).requires_grad_() for h in (hq, hkv, hkv))


def _assert_k4_close(got, q, k, v, causal, window):
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        return
    want = want.float()
    moved = ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                    causal=causal, window=window)
    tol = 2e-5 + 2.0 ** -8 * moved + 2.0 ** -7 * want.abs()
    assert float(((got.float() - want).abs() / tol).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,causal,window", CELLS)
def test_k4_function_matches_plain_autograd(cuda, dtype, hq, hkv, causal,
                                            window):
    q, k, v = _qkv(2, hq, hkv, 256, 64, seed=hq + hkv + window, dtype=dtype)
    up = torch.randn(q.shape, device="cuda").to(dtype)
    ops.reset_launch_counts()
    got = ops.attention(q, k, v, causal=causal, window=window)
    assert ops.launch_counts()["flash_attention"] == 1
    _assert_k4_close(got.detach(), q.detach(), k.detach(), v.detach(),
                     causal, window)
    grads = torch.autograd.grad(got, (q, k, v), up)
    plain = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(
        *plain, causal=causal, window=window), plain, up)
    for a, b in zip(grads, want):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["small_f32", "full_bf16"])
def test_k4_function_at_the_training_shapes(cuda, cell):
    """The forward at the shapes training gives K4: build_small_cfg's
    (8 × 512 tokens, 8 query heads over 4, D = 64, float32: the SIMT
    instance) and phi4-mini's (24 over 8, D = 128, bf16: ``wgmma``)."""
    if cell == "small_f32":
        cfg, dtype = build_small_cfg("phi4-mini-3.8b"), torch.float32
    else:
        cfg, dtype = get_config("phi4-mini-3.8b"), torch.bfloat16
    q, k, v = _qkv(8, cfg.n_heads, cfg.n_kv_heads, 512,
                   cfg.resolved_head_dim, seed=13, dtype=dtype)
    ops.reset_launch_counts()
    got = ops.attention(q, k, v, causal=True)
    assert ops.launch_counts()["flash_attention"] == 1
    _assert_k4_close(got.detach(), q.detach(), k.detach(), v.detach(),
                     True, 0)


@pytest.mark.cuda
def test_k4_function_gives_only_the_gradients_asked_for(cuda):
    q, k, v = _qkv(1, 4, 2, 128, 32, seed=3, dtype=torch.float32)
    k, v = k.detach(), v.detach()
    (dq,) = torch.autograd.grad(ops.attention(q, k, v).sum(), (q,))
    plain = q.detach().requires_grad_()
    (want,) = torch.autograd.grad(ref.attention_ref(plain, k, v).sum(),
                                  (plain,))
    assert torch.equal(dq, want)


def _small():
    return dataclasses.replace(
        get_config("phi4-mini-3.8b"), n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        vocab_pad_multiple=128, dtype="float32", use_pallas=True)


@pytest.mark.cuda
@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("dots", 2),
                                             ("full", 2)])
def test_k4_launches_in_the_loss_and_its_recompute(cuda, remat, per_layer):
    """K4 runs in every layer's forward, and again in the backward's
    recompute when the layer is rematerialised (its output is not a matrix
    product, so ``dots`` recomputes it too)."""
    cfg = dataclasses.replace(_small(), remat=remat)
    params = init_model(cfg, device="cuda", dtype=cfg.param_dtype)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda")
    ops.reset_launch_counts()
    loss = loss_fn(params, cfg, toks, toks)
    torch.autograd.grad(loss, leaves)
    assert ops.launch_counts()["flash_attention"] == per_layer * cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("micro,comp", [(1, False), (2, True)])
def test_train_step_on_the_card_matches_the_cpu(cuda, micro, comp):
    cfg = _small()
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=4, eps=1e-3)
    batch = lm_batch(LMDataConfig(cfg.vocab_size, 64, 4), 0)
    start = init_model(cfg, device="cpu", dtype=cfg.param_dtype)
    out = {}
    for dev in ("cpu", "cuda"):
        # a copy on either device: the step updates its parameters in place
        params = tree_map(lambda t: t.to(dev, copy=True), start)
        opt_state, comp_state = init_train_state(cfg, params,
                                                 compress_grads=comp)
        step = make_train_step(cfg, opt, num_microbatches=micro,
                               compress_grads=comp)
        losses = []
        for _ in range(2):
            o = step(params, opt_state, comp_state, batch)
            params, opt_state, comp_state = o.params, o.opt_state, \
                o.comp_state
            losses.append(float(o.metrics["loss"]))
        out[dev] = (losses, params)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(tree_leaves(out["cuda"][1]), tree_leaves(out["cpu"][1])):
        assert a.is_cuda
        off = (a.cpu() - b).abs() > 1e-6
        # int8 roundings that fall the other way (compress_grads)
        assert float(off.float().mean()) <= (1e-3 if comp else 0.0)


@pytest.mark.cuda
def test_bf16_compute_over_float32_masters_trains(cuda):
    """The chip cell's arithmetic at a small size: bf16 activations over
    float32 masters, K4's wgmma instance (D = 128), remat full."""
    cfg = dataclasses.replace(_small(), dtype="bfloat16", remat="full",
                              n_heads=2, n_kv_heads=1, head_dim=128)
    params = init_model(cfg, device="cuda", dtype=cfg.param_dtype)
    opt_state, comp_state = init_train_state(cfg, params)
    step = make_train_step(cfg, AdamWConfig(warmup_steps=2, total_steps=8))
    data = LMDataConfig(cfg.vocab_size, 256, 4)
    ops.reset_launch_counts()
    for i in range(3):
        o = step(params, opt_state, comp_state, lm_batch(data, i))
        params, opt_state, comp_state = o.params, o.opt_state, o.comp_state
        assert np.isfinite(float(o.metrics["loss"]))
        assert float(o.metrics["grad_norm"]) > 0
    assert ops.launch_counts()["flash_attention"] == 3 * 2 * cfg.n_layers
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    tree = {"w": torch.randn(5, 3, device="cuda"),
            "h": torch.randn(4, device="cuda").bfloat16(),
            "step": torch.tensor(3, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 1, tree)
    like = tree_map(torch.zeros_like, tree)
    got = restore_checkpoint(str(tmp_path), 1, like)
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_driver_restart_reproduces_the_clean_losses_on_the_card(cuda,
                                                                tmp_path):
    cfg = build_small_cfg("phi4-mini-3.8b", n_layers=2, d_model=128,
                          vocab_size=512, use_pallas=True)
    runs = {}
    for name, fail_at in (("clean", None), ("restart", 3)):
        fails = {fail_at}

        def hook(step, fails=fails):
            if step in fails:
                fails.discard(step)
                raise StepFailure("injected")

        drv = make_driver(cfg, steps=6, batch=2, seq=128, lr=3e-4,
                          ckpt_dir=str(tmp_path / name), ckpt_every=2,
                          device="cuda", fault_hook=hook)
        drv.run()
        runs[name] = drv
    clean = [m["loss"] for m in runs["clean"].metrics_log]
    rest = [m["loss"] for m in runs["restart"].metrics_log]
    assert runs["restart"].restarts == 1
    assert rest == clean[:3] + clean[2:]
