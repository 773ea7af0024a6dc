"""Training the moe, ssm and hybrid families and training from embeddings
on the card: K4 under autograd at the families' training shapes, K4's
route against the plain route, the train step on the card against the
CPU, the MoE backward's reproducibility and TrainDriver's restart.

Every test here is marked ``cuda`` and skips where there is no GPU. This
file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda*.py

Tolerances: K4's forward as tests/test_torch_cuda_train.py holds it (bf16
element by element, atol 2e-5 + 2^-8·plain(q, k, |v|), rtol 2^-7). K4's
route against the plain chunked attention, float32, the same weights and
batch (a MoE run replays the plain run's routing, since a rounding can flip
a top-k choice): the loss within rtol 1e-5 and each gradient leaf within
1e-4 of its norm, as chip_smoke.py's phase train_families holds them (on
an H100 at build_small_cfg and 8 x 512 tokens: the losses equal, the worst
leaf 1.5e-5 of its norm). The
train step on the card against the CPU, float32: the loss at rtol 1e-5 and
the parameters after two steps at atol 1e-6, AdamW eps 1e-3, as the dense
test there.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_common import cuda  # noqa: F401
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from repro_torch.configs import get_config
from repro_torch.data import LMDataConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import batch_for_step, build_small_cfg, \
    make_driver
from repro_torch.models import init_model, loss_fn
from repro_torch.models import moe as moe_mod
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import StepFailure, init_train_state, \
    make_train_step

ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "mamba2-780m",
         "zamba2-7b", "pixtral-12b", "musicgen-medium"]
ROUTE_LOSS_RTOL, ROUTE_GRAD_RTOL = 1e-5, 1e-4


def _tiny(arch: str, **over):
    """build_small_cfg at 2 layers (4 for the hybrid: a group of 3 and a
    tail) of width 128, a vocab of 512, K4 on."""
    base = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                head_dim=32, d_ff=256, vocab_size=512, use_pallas=True)
    if get_config(arch).family == "hybrid":
        base["n_layers"] = 4
    return build_small_cfg(arch, **dict(base, **over))


def _k4_per_step(cfg) -> int:
    """K4 launches in one loss and backward under remat dots or full."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return 2 * (cfg.n_layers // cfg.shared_attn_every)
    first = cfg.family == "moe" and cfg.moe.first_dense_ff
    return 2 * cfg.n_layers - (1 if first else 0)


def _assert_k4_close(got, q, k, v):
    want = ref.flash_attention_ref(q, k, v, causal=True).float()
    moved = ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                    causal=True)
    tol = 2e-5 + 2.0 ** -8 * moved + 2.0 ** -7 * want.abs()
    assert float(((got.float() - want).abs() / tol).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-7b",
                                  "musicgen-medium"])
def test_k4_function_at_the_family_training_shapes(cuda, arch):
    """(8, H, 512, D) bf16 causal at each attention cell's published heads:
    deepseek 16 of 128, zamba2's shared block 32 of 112, musicgen 24 of 64.
    One launch, held to K4's tolerance; the gradients are the plain
    version's autograd bit for bit."""
    cfg = get_config(arch)
    g = torch.Generator(device="cuda").manual_seed(5)
    shape = (8, cfg.n_heads, 512, cfg.resolved_head_dim)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_() for _ in range(3))
    up = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    ops.reset_launch_counts()
    got = ops.attention(q, k, v, causal=True)
    assert ops.launch_counts()["flash_attention"] == 1
    _assert_k4_close(got.detach(), q.detach(), k.detach(), v.detach())
    grads = torch.autograd.grad(got, (q, k, v), up)
    plain = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*plain, causal=True), plain,
                               up)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


class _Routing:
    """Records ``moe.dispatch``'s decisions, or replays recorded ones in
    order with gate weights from the probabilities given."""

    def __init__(self, inner, replay=None):
        self.inner = inner
        self.calls = [] if replay is None else list(replay)
        self.replay = replay is not None

    def __call__(self, probs, k, cap):
        if not self.replay:
            d = self.inner(probs, k, cap)
            self.calls.append(d)
            return d
        rec = self.calls.pop(0)
        G, t_g, _ = probs.shape
        gate = probs.gather(2, rec.expert.reshape(G, t_g, k))
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return moe_mod.Dispatch(rec.expert, rec.slot, rec.keep, torch.where(
            rec.keep, gate.reshape(G, t_g * k), 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_k4_route_matches_the_plain_route(cuda, arch, monkeypatch):
    """float32, the same weights and batch (embeddings for pixtral and
    musicgen): the loss and every gradient leaf through K4's SIMT instance
    against the plain chunked attention, with K4 launched in every
    attention layer and its recompute."""
    cfg = _tiny(arch)
    params = init_model(cfg, device="cuda", dtype=cfg.param_dtype)
    batch = {k: v.cuda() for k, v in batch_for_step(
        cfg, LMDataConfig(cfg.vocab_size, 256, 4), 0).items()}

    def run(c, routing):
        monkeypatch.setattr(moe_mod, "dispatch", routing)
        flat, spec = tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        loss = loss_fn(tree_unflatten(leaves, spec), c, batch.get("tokens"),
                       batch["labels"], embeds=batch.get("embeds"))
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    rec = _Routing(moe_mod.dispatch)
    want_loss, want = run(dataclasses.replace(cfg, use_pallas=False), rec)
    ops.reset_launch_counts()
    got_loss, got = run(cfg, _Routing(rec.inner, rec.calls))
    assert ops.launch_counts()["flash_attention"] == _k4_per_step(cfg)
    torch.testing.assert_close(got_loss, want_loss, rtol=ROUTE_LOSS_RTOL,
                               atol=0)
    for a, b in zip(got, want):
        scale = float(b.norm())
        assert float((a - b).norm()) <= ROUTE_GRAD_RTOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b", "pixtral-12b",
                                  "musicgen-medium"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Two steps of the launcher's batches (two microbatches for musicgen:
    embeddings and (b, s, 4) labels split) on the card and on the CPU from
    the same float32 masters. The moe archs are left out: a rounding can
    flip a routing decision between the two devices."""
    cfg = _tiny(arch)
    micro = 2 if arch == "musicgen-medium" else 1
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=4, eps=1e-3)
    data = LMDataConfig(cfg.vocab_size, 64, 4)
    start = init_model(cfg, device="cpu", dtype=cfg.param_dtype)
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev, copy=True), start)
        opt_state, comp_state = init_train_state(cfg, params)
        step = make_train_step(cfg, opt, num_microbatches=micro)
        losses = []
        for i in range(2):
            o = step(params, opt_state, comp_state,
                     batch_for_step(cfg, data, i))
            params, opt_state, comp_state = o.params, o.opt_state, \
                o.comp_state
            losses.append(float(o.metrics["loss"]))
        out[dev] = (losses, params)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(tree_leaves(out["cuda"][1]), tree_leaves(out["cpu"][1])):
        assert a.is_cuda and float((a.cpu() - b).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_backward_is_bit_reproducible(cuda, dtype):
    """moe_block's gradients, twice from the same inputs at a shape where
    the capacity drops assignments (64 experts top-6, 16 groups of 256
    tokens): equal bit for bit. No step of the dispatch, forward or
    backward, adds with atomics."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), d_model=256,
                              dtype="float32" if dtype == torch.float32
                              else "bfloat16")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, d_ff_expert=64, d_ff_shared=128))
    g = torch.Generator(device="cuda").manual_seed(0)
    params = moe_mod.init_moe(g, cfg, dtype)
    x = torch.randn((4, 1024, 256), generator=g, device="cuda").to(dtype)
    up = torch.randn((4, 1024, 256), generator=g, device="cuda").to(dtype)
    flat, spec = tree_flatten(params)
    runs = []
    for _ in range(2):
        ins = [t.detach().requires_grad_() for t in [x] + flat]
        out = moe_mod.moe_block(tree_unflatten(ins[1:], spec), cfg, ins[0])
        loss = (out.y * up).float().sum() + out.aux_loss
        runs.append(torch.autograd.grad(loss, ins))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "musicgen-medium"])
def test_driver_restart_is_bit_equal_on_the_card(cuda, arch, tmp_path):
    """The launcher's driver with a failure at step 3: the restarted run's
    losses equal the uninterrupted run's bit for bit, the MoE arch's
    included (its dispatch is deterministic on the card)."""
    cfg = _tiny(arch)
    runs = {}
    for name, fail_at in (("clean", None), ("restart", 3)):
        fails = {fail_at}

        def hook(step, fails=fails):
            if step in fails:
                fails.discard(step)
                raise StepFailure("injected")

        drv = make_driver(cfg, steps=6, batch=4, seq=128, lr=3e-4,
                          ckpt_dir=str(tmp_path / name), ckpt_every=2,
                          device="cuda", fault_hook=hook)
        drv.run()
        runs[name] = drv
    clean = [m["loss"] for m in runs["clean"].metrics_log]
    rest = [m["loss"] for m in runs["restart"].metrics_log]
    assert runs["restart"].restarts == 1
    assert rest == clean[:3] + clean[2:]
