"""Training the moe, ssm and hybrid families and training from embeddings
in the port (``loss_fn``, ``make_train_step``, ``_remat``, the launcher's
``TrainDriver``) against the JAX package on the CPU.

Sizes: the JAX smoke tests' reduction (``tests/_torch_families.py``:
``small_cfg``, d_model 128, 4 layers, 4 heads of 32, 8 experts top-2 (top-1
for llama4-scout), d_state 16, head_dim 32, chunk 32; zamba2 at 7 layers
with the shared block every 3), float32, one set of weights for both
packages, a batch of 2 x 64 (tokens, or N(0, 1) embeddings with labels (2,
64) for pixtral and (2, 64, 4) for musicgen's codebook head) made with
numpy. These configs have ``use_pallas=False``, so neither side runs a
Pallas kernel. One jitted JAX train step per arch, run twice and shared
through a module-scoped fixture, gives the reference's loss and gradients
too: AdamW runs with beta1 = 0 and no clipping, so m after a step is that
step's gradient exactly (m = 0·m + 1·g) and the loss is its metric. The
AdamW arithmetic with beta1 and clipping is held by
tests/test_torch_train.py. musicgen's steps run in two microbatches (its
embeddings and (b, s, 4) labels split; the mean of the two halves' losses
and gradients is the whole batch's up to rounding, as its family has no
routing); the other archs in one.

Tolerances, each with the largest difference measured here (float32; the
two packages sum in different orders) and its margin:
  * loss: rtol 1e-6 (measured 1.4e-7, llama4-scout; margin 7);
  * gradients: atol 2e-6 on every leaf, the first step's and (as m) the
    second's (measured 6.2e-7, zamba2-7b's embedding at the second step,
    against gradients of up to 0.12; at the first step 3.9e-7 zamba2,
    2.8e-7 llama4-scout, 2.5e-7 deepseek, 2.0e-7 mamba2, 3.9e-8 pixtral,
    1.5e-8 musicgen; margin 3.2);
  * two train steps, AdamW eps 1e-3 as tests/test_torch_train.py explains
    (a gradient difference δ moves a parameter by at most lr·δ/eps): lr
    rtol 1e-7 (equal), the loss rtol 1e-6 (7.7e-8, margin 13), the
    gradient norm rtol 1e-4 (1.5e-5, zamba2, whose leaves' small
    differences add up in its norm; the others 1.7e-6 at most; margin
    6.8), parameters atol 3e-7 (1.19e-7, one float32 spacing at 1.49;
    margin 2.5), v atol 2e-8 (6.5e-9, zamba2's embedding, of up to
    2.2e-3; margin 3.1);
  * the remat policies: bit-equal (the same float32 operations again).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from _torch_common import close
from _torch_families import model, reference_tree
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.runtime import init_train_state as jax_init_train_state
from repro.runtime import make_train_step as jax_make_train_step
from repro_torch.checkpoint import all_steps
from repro_torch.data import LMDataConfig
from repro_torch.launch import train as train_cli
from repro_torch.models import loss_fn
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import (StepFailure, init_train_state,
                                 make_train_step)

ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "mamba2-780m",
         "zamba2-7b", "pixtral-12b", "musicgen-medium"]
B, S, CHUNK = 2, 64, 32
LOSS_TOL = dict(rtol=1e-6, atol=0)
GRAD_ATOL = 2e-6
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=4, eps=1e-3, beta1=0.0,
           grad_clip=0.0)
METRIC_RTOL = {"lr": 1e-7, "loss": 1e-6, "grad_norm": 1e-4}
STEP_ATOL = {"params": 3e-7, "m": GRAD_ATOL, "v": 2e-8}
MICRO = {"musicgen-medium": 2}


def _batch(cfg) -> dict:
    """numpy tokens and next-token labels, or embeddings and labels."""
    g = np.random.default_rng(11)
    if cfg.modality in ("vision", "audio"):
        emb = g.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        shape = (B, S, cfg.num_codebooks) if cfg.modality == "audio" \
            else (B, S)
        return {"embeds": emb, "labels": g.integers(
            0, cfg.vocab_size, shape).astype(np.int32)}
    toks = g.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _port_loss_and_grads(tcfg, params, batch: dict, **kw):
    """``loss_fn`` and the gradient of every leaf (zeros for a leaf that
    the loss does not reach, as ``jax.value_and_grad`` gives)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tb = _torch_batch(batch)
    loss = loss_fn(params, tcfg, tb.get("tokens"), tb["labels"],
                   embeds=tb.get("embeds"), **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), tree_unflatten(list(grads), tree_flatten(params)[1])


def _assert_trees_close(got: dict, want, what: str, atol: float) -> None:
    """A port tree (through ``reference_tree``) against the reference's,
    leaf by leaf, the same leaves and shapes."""
    want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, want))[0])
    mine = dict(jax.tree_util.tree_flatten_with_path(
        reference_tree(got))[0])
    assert mine.keys() == want.keys(), what
    for path, w in want.items():
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert mine[path].shape == w.shape, name
        close(mine[path], w, rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def jax_two_steps():
    """Per arch, once: two reference train steps on one batch; each step's
    metrics, its m (the step's gradient, beta1 = 0), and the state after
    the second."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, _, jparams, _ = model(name)
            step = jax.jit(jax_make_train_step(
                jcfg, JaxAdamWConfig(**OPT),
                num_microbatches=MICRO.get(name, 1)))
            opt, comp = jax_init_train_state(jcfg, jparams)
            b = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
            params, metrics, grads = jparams, [], []
            for _ in range(2):
                out = step(params, opt, comp, b)
                params, opt, comp = out.params, out.opt_state, out.comp_state
                metrics.append({k: float(v) for k, v in out.metrics.items()})
                grads.append(opt.m)
            cache[name] = params, opt, metrics, grads
        return cache[name]
    return get


# ------------------------------------------------------------ loss_fn

@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_every_gradient_match_jax(name, jax_two_steps):
    """The loss (cross-entropy over four chunks of the LM or codebook
    head, the MoE aux term, the codebook mean over t·codebooks) and the
    gradient of every leaf against the reference's ``value_and_grad`` in
    its first train step (one head chunk there), the unreached token table
    of the embedding archs included (zero on both sides)."""
    _, tcfg, _, tparams = model(name)
    params = tree_map(torch.clone, tparams)
    loss, grads = _port_loss_and_grads(tcfg, params, _batch(tcfg),
                                       head_chunk=CHUNK)
    _, _, want_metrics, want_grads = jax_two_steps(name)
    assert loss.dtype == torch.float32
    close(loss, want_metrics[0]["loss"], **LOSS_TOL)
    _assert_trees_close(grads, want_grads[0], "grad", GRAD_ATOL)
    if tcfg.modality in ("vision", "audio"):
        assert not grads["embed"]["table"].any()


@pytest.mark.parametrize("name,calls", [
    # (family's block, its calls without remat, with; the dense block)
    ("deepseek-moe-16b", ("moe_block", 3, 6, 1, 1)),
    ("mamba2-780m", ("ssm_block", 4, 8, 0, 0)),
    ("zamba2-7b", ("ssm_block", 7, 13, 2, 4)),
])
def test_remat_policies_give_bit_equal_gradients(name, calls, monkeypatch):
    """none, dots and full give the same gradients bit for bit, and each
    family rematerialises what the reference's ``_remat`` wraps: every MoE
    layer but not deepseek's dense ``layer0``; every SSM layer; each
    hybrid group of 3 SSM layers with its shared block, but not the tail
    layer (zamba2: 7 = 2 x 3 + 1). Counted: the family block's and the
    dense block's calls in one forward and backward."""
    fn, bare, remat, dense_bare, dense_remat = calls
    counts = {}

    def counting(key, f):
        def wrapped(*a, **k):
            counts[key] = counts.get(key, 0) + 1
            return f(*a, **k)
        return wrapped

    monkeypatch.setattr(tfm, fn, counting(fn, getattr(tfm, fn)))
    monkeypatch.setattr(tfm, "_dense_block",
                        counting("dense", tfm._dense_block))
    _, tcfg, _, tparams = model(name)
    out = {}
    for policy in ("none", "dots", "full"):
        counts.clear()
        cfg = dataclasses.replace(tcfg, remat=policy)
        out[policy] = _port_loss_and_grads(
            cfg, tree_map(torch.clone, tparams), _batch(cfg))
        want = (bare, dense_bare) if policy == "none" \
            else (remat, dense_remat)
        assert (counts[fn], counts.get("dense", 0)) == want, policy
    for policy in ("dots", "full"):
        assert torch.equal(out[policy][0], out["none"][0]), policy
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(out[policy][1]), tree_leaves(out["none"][1]))), policy


# --------------------------------------------------------- train step

@pytest.mark.parametrize("name", ARCHS)
def test_two_train_steps_match_jax(name, jax_two_steps):
    """Two ``make_train_step`` steps on one batch (two microbatches for
    musicgen): lr, the loss and the gradient norm of each step, then
    parameters, m (the second step's gradient) and v against the
    reference's."""
    _, tcfg, _, tparams = model(name)
    micro = MICRO.get(name, 1)
    step = make_train_step(tcfg, AdamWConfig(**OPT), num_microbatches=micro)
    params = tree_map(torch.clone, tparams)
    opt, comp = init_train_state(tcfg, params)
    want_params, want_opt, want_metrics, _ = jax_two_steps(name)
    for want in want_metrics:
        out = step(params, opt, comp, _torch_batch(_batch(tcfg)))
        params, opt, comp = out.params, out.opt_state, out.comp_state
        for key, rtol in METRIC_RTOL.items():
            close(out.metrics[key], want[key], rtol=rtol, atol=0,
                  err_msg=key)
    assert int(opt.step) == int(want_opt.step) == 2
    for what, got, want in (("params", params, want_params),
                            ("m", opt.m, want_opt.m),
                            ("v", opt.v, want_opt.v)):
        _assert_trees_close(got, want, what, STEP_ATOL[what])


# ------------------------------------------- the launcher and restarts

_BUILD_SMALL_CFG = train_cli.build_small_cfg


def _tiny_cfg(arch: str, **over):
    """``build_small_cfg`` cut to 2 layers of width 64 and a vocab of 256
    (tests/test_torch_train_runtime.py's size); the hybrid at 4 layers, so
    that one group of 3 meets the shared block and one layer is the
    tail."""
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                d_ff=128, vocab_size=256, use_pallas=True)
    if train_cli.get_config(arch).family == "hybrid":
        base["n_layers"] = 4
    return _BUILD_SMALL_CFG(arch, **dict(base, **over))


@pytest.mark.parametrize("name", ARCHS)
def test_driver_restart_resumes_the_family_trees(name, tmp_path):
    """The launcher's driver at ``_tiny_cfg``: a failure at step 5
    restores step 3's checkpoint (the family's own leaves: ``layer0``,
    the experts, ``shared_attn``, the SSM leaves, ``cb_head``) and
    replays; the losses and the final parameters and moments equal the
    uninterrupted run's bit for bit."""
    cfg = _tiny_cfg(name)

    def run(tag, fail_at=()):
        fails = set(fail_at)

        def hook(step):
            if step in fails:
                fails.discard(step)
                raise StepFailure(f"injected at {step}")

        drv = train_cli.make_driver(
            cfg, steps=8, batch=2, seq=32, lr=3e-3,
            ckpt_dir=str(tmp_path / tag), ckpt_every=3, device="cpu",
            fault_hook=hook)
        return drv, drv.run()

    clean, want = run("clean")
    faulty, got = run("faulty", [5])
    losses = [m["loss"] for m in clean.metrics_log]
    replay = [m["loss"] for m in faulty.metrics_log]
    assert faulty.restarts == 1 and len(replay) == 10
    assert replay[:5] == losses[:5] and replay[5:] == losses[3:]
    assert all(np.isfinite(losses))
    params = got[0]
    own = {"moe": ["layer0"] if cfg.moe.first_dense_ff else [],
           "hybrid": ["shared_attn"],
           "audio": ["cb_head"]}.get(cfg.family, [])
    assert all(k in params for k in own), sorted(params)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))
    assert all_steps(str(tmp_path / "faulty")) == [3, 6, 8]


def test_train_cli_trains_every_family(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.train --arch <arch> --device cpu``
    for each of the six archs at ``_tiny_cfg``; ``batch_for_step`` is a
    pure function of the step, with embeddings for pixtral and musicgen
    and (b, s, 4) labels for musicgen."""
    monkeypatch.setattr(train_cli, "build_small_cfg", _tiny_cfg)
    for name in ARCHS:
        driver = train_cli.main([
            "--arch", name, "--device", "cpu", "--steps", "1", "--batch",
            "2", "--seq", "16", "--ckpt-dir", str(tmp_path / name)])
        assert len(driver.metrics_log) == 1, name
        assert np.isfinite(driver.metrics_log[0]["loss"]), name
        assert all_steps(str(tmp_path / name)) == [1], name
        assert "steps=1 first_loss=" in capsys.readouterr().out
        cfg = _tiny_cfg(name)
        data = LMDataConfig(cfg.vocab_size, 16, 2)
        b5, again, b6 = (train_cli.batch_for_step(cfg, data, s)
                         for s in (5, 5, 6))
        assert b5.keys() == again.keys() and all(
            torch.equal(b5[k], again[k]) and not torch.equal(b5[k], b6[k])
            for k in b5), name
        if cfg.modality in ("vision", "audio"):
            assert set(b5) == {"embeds", "labels"}
            assert b5["embeds"].shape == (2, 16, cfg.d_model)
            assert b5["labels"].shape == ((2, 16, 4) if name ==
                                          "musicgen-medium" else (2, 16))
        else:
            assert set(b5) == {"tokens", "labels"}
