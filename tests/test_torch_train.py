"""Training in the port (``loss_fn``, K4 under autograd, ``optim``,
``make_train_step``) against the JAX package on the CPU.

The setup is tests/test_torch_lm.py's small phi4-mini (4 layers, d_model
128, 4 query heads over one KV head of 32, vocab 512, float32,
``use_pallas``: the JAX side runs its Pallas flash kernel in interpret
mode and its ``custom_vjp`` backward through ``attention_ref``, the port
K4's plain version and the same backward). Weights come from the JAX
``init_model`` through ``params_from_reference(dtype=float32)``; tokens
from numpy; a batch of 2 × 64 tokens (128, so ``head_chunk=32`` makes four
chunks). One JAX ``value_and_grad`` and two JAX train-step compilations
are shared through module-scoped fixtures.

Tolerances, each with the largest difference measured here (float32,
the two packages sum in different orders) and its margin:
  * loss: rtol 1e-6 (measured 6.4e-8 relative, margin 15);
  * gradients: atol 5e-7 on every leaf (measured 7.2e-8 against gradients
    of up to 0.1, margin 7);
  * bf16 compute over float32 masters (``dtype="bfloat16"`` on both
    sides, the same weights): the loss rtol 5e-4 (measured 8.6e-5, margin
    5.8; the reference's bf16 loss lies 2.6e-4 from its float32 one); each
    leaf's gradient within 3e-2 of the reference's in relative norm
    (measured 3.2e-3 to 1.87e-2, margin 1.6), and its distance from the
    float32 gradient between 0.8 and 1.25 times the reference's (measured
    0.97 to 1.07; a leaf computed in float32 would give about 0). The
    embedding's gradient sums repeated tokens in float32 in the port
    (gather, then cast) and in bf16 in the reference (cast, then gather):
    1.366e-2 from the reference's, and 1.367e-2 when the port is made to
    cast first;
  * K4 under autograd at (1, 4, 256, 32), GQA 2: output and gradients
    atol 2e-5, the block tolerance of tests/test_kernels_pallas.py
    (measured at most 1.9e-6, margin 10);
  * two train steps: lr rtol 1e-7 (measured equal), the loss rtol 1e-6
    (6.8e-8), the gradient norm rtol 1e-5 (2.5e-6, margin 4); parameters
    atol 1e-7 (3.0e-8, one float32 spacing at 0.26), m atol 5e-8 (8.4e-9),
    v atol 1e-9 (2.2e-10), the compression residuals atol 5e-7 (2.0e-7).
    AdamW's eps is 1e-3 in the step cells: Adam divides each gradient by
    its own magnitude, and with the default 1e-8 an element whose gradient
    is at the level of the rounding differences (about 1e-8) moves by a
    good part of a step in either package (measured 6.4e-5 = 21 % of lr),
    which no tolerance below a step could hold; with 1e-3 a gradient
    difference δ moves a parameter by at most lr·δ/eps. With
    ``compress_grads`` an element whose (g + e)/scale lies within the
    rounding difference of a half-integer can round to the neighbouring
    int8 value in the two packages: at most 0.1 % of a tensor's elements
    may then lie outside those tolerances (measured 0.0076 %).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from _torch_common import close, n, t
from repro.configs import get_config as jax_config
from repro.kernels import flash_attention as jax_flash
from repro.models import init_model as jax_init_model
from repro.models import loss_fn as jax_loss_fn
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import compress as jax_compress
from repro.optim import decompress as jax_decompress
from repro.optim import init_adamw as jax_init_adamw
from repro.optim import init_compression as jax_init_compression
from repro.optim import schedule as jax_schedule
from repro.runtime import init_train_state as jax_init_train_state
from repro.runtime import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import (forward, init_model, loss_fn,
                                params_from_reference)
from repro_torch.optim import (AdamWConfig, adamw_update,
                               clip_by_global_norm, compress, decompress,
                               global_norm, init_adamw, init_compression,
                               schedule)
from repro_torch.runtime import init_train_state, make_train_step

ARCH = "phi4-mini-3.8b"
OVER = dict(n_layers=4, d_model=128, vocab_size=512, vocab_pad_multiple=128,
            dtype="float32", n_heads=4, n_kv_heads=1, d_ff=256, head_dim=32,
            use_pallas=True)
B, S, CHUNK = 2, 64, 32
LOSS_TOL = dict(rtol=1e-6, atol=0)
GRAD_ATOL = 5e-7
K4_TOL = dict(rtol=0, atol=2e-5)
# bf16 compute over float32 masters (see the module docstring)
BF16_LOSS_TOL = dict(rtol=5e-4, atol=0)
BF16_GRAD_RTOL = 3e-2
BF16_RATIO = (0.8, 1.25)
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=4, eps=1e-3)
STEP_TOL = {"params": 1e-7, "m": 5e-8, "v": 1e-9, "error": 5e-7}
# the share of a tensor's elements that may round to the neighbouring int8
# value in the two packages (compress_grads)
FLIPS = 1e-3


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX params, token rows (B, S + 1))."""
    jcfg = dataclasses.replace(jax_config(ARCH), **OVER)
    tcfg = dataclasses.replace(get_config(ARCH), **OVER)
    # under jit: the same weights as eagerly, a few seconds cheaper
    jparams = jax.jit(jax_init_model, static_argnums=0)(jcfg,
                                                       jax.random.key(0))
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    return jcfg, tcfg, jparams, toks


def _port_params(jparams, tcfg):
    return params_from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu", dtype=torch.float32)


def _stacked(tree) -> dict:
    """A port tree (dicts, a list of layer dicts) as numpy in the
    reference's layout (layers stacked on a leading axis)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return n(x)
    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    layers = [conv(p) for p in tree["layers"]]
    out["layers"] = jax.tree.map(lambda *xs: np.stack(xs), *layers)
    return out


def _assert_trees_close(got, want, what, atol, flips=0.0):
    """Every leaf within ``atol`` of the reference's, but at most a share
    ``flips`` of its elements (int8 roundings that fall the other way)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    mine = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(mine) == len(flat), what
    for path, w in flat:
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert mine[path].shape == w.shape, name
        off = np.abs(mine[path].astype(np.float64) - w) > atol
        assert off.mean() <= flips, \
            f"{name}: {off.sum()} of {off.size} elements beyond {atol:g}"


@pytest.fixture(scope="module")
def jax_value_and_grad(model):
    jcfg, _, jparams, toks = model
    fn = jax.jit(jax.value_and_grad(lambda p: jax_loss_fn(
        p, jcfg, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]),
        head_chunk=CHUNK)))
    loss, grads = fn(jparams)
    return float(loss), jax.tree.map(np.asarray, grads)


# ------------------------------------------------------------ loss_fn

@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("head_chunk", [16_384, CHUNK])
def test_loss_and_every_gradient_match_jax(model, jax_value_and_grad, remat,
                                           head_chunk):
    """One head chunk and four, each remat policy: the loss and the
    gradient of every leaf equal ``jax.value_and_grad``'s."""
    _, tcfg, jparams, toks = model
    tcfg = dataclasses.replace(tcfg, remat=remat)
    params = _port_params(jparams, tcfg)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, tcfg, t(toks[:, :-1]), t(toks[:, 1:]),
                   head_chunk=head_chunk)
    grads = torch.autograd.grad(loss, leaves)
    want_loss, want_grads = jax_value_and_grad
    assert loss.dtype == torch.float32
    close(loss, want_loss, **LOSS_TOL)
    grads = tree_unflatten(list(grads), tree_flatten(params)[1])
    _assert_trees_close(_stacked(grads), want_grads, "grad", GRAD_ATOL)


def test_bf16_compute_over_float32_masters_matches_jax(model,
                                                     jax_value_and_grad):
    """bf16 compute over the same float32 masters on both sides: the loss
    and every gradient against ``jax.value_and_grad`` of the reference at
    ``dtype="bfloat16"``. The two packages round in different orders, so
    the port's gradients lie about as far from the reference's as either
    lies from the float32 gradients; a leaf computed in the wrong dtype
    would move its own distance from float32, which the ratio holds."""
    jcfg, tcfg, jparams, toks = model
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: jax_loss_fn(
        p, jcfg, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]),
        head_chunk=CHUNK)))(jparams)
    params = _port_params(jparams, tcfg)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, tcfg, t(toks[:, :-1]), t(toks[:, 1:]),
                   head_chunk=CHUNK)
    grads = torch.autograd.grad(loss, leaves)
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads)
    close(loss, float(want_loss), **BF16_LOSS_TOL)
    got = dict(jax.tree_util.tree_flatten_with_path(_stacked(
        tree_unflatten(list(grads), tree_flatten(params)[1])))[0])
    f32 = dict(jax.tree_util.tree_flatten_with_path(jax_value_and_grad[1])[0])
    for path, w in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, want))[0]:
        name = jax.tree_util.keystr(path)
        w, g, r = (x.astype(np.float64) for x in (w, got[path], f32[path]))
        scale = np.linalg.norm(w)
        off = np.linalg.norm(g - w) / scale
        ratio = np.linalg.norm(g - r) / np.linalg.norm(w - r)
        assert off <= BF16_GRAD_RTOL, f"{name}: {off:.3e} from the reference"
        assert BF16_RATIO[0] <= ratio <= BF16_RATIO[1], \
            f"{name}: {ratio:.3f} of the reference's distance from float32"


def test_remat_policies_give_bit_equal_gradients(model):
    """Rematerialisation recomputes the same float32 operations, so the
    three policies' gradients are equal bit for bit."""
    _, tcfg, jparams, toks = model
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = _port_params(jparams, cfg)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, cfg, t(toks[:, :-1]), t(toks[:, 1:]))
        out[remat] = torch.autograd.grad(loss, leaves)
    for remat in ("dots", "full"):
        assert all(torch.equal(a, b) for a, b in zip(out["none"],
                                                     out[remat])), remat


def test_float32_masters_compute_the_serving_forward():
    """Float32 masters under bf16 compute give the logits of the bf16-held
    serving weights bit for bit: each cast at use equals the weight that
    serving holds."""
    cfg = dataclasses.replace(get_config(ARCH), **dict(OVER, dtype="bfloat16"))
    masters = init_model(cfg, device="cpu", dtype=cfg.param_dtype)
    served = init_model(cfg, device="cpu")
    assert masters["layers"][0]["mlp"]["w_up"].dtype == torch.float32
    assert served["layers"][0]["mlp"]["w_up"].dtype == torch.bfloat16
    assert served["ln_f"]["scale"].dtype == torch.float32
    toks = t(np.random.default_rng(1).integers(0, 512, (1, 64)))
    assert torch.equal(forward(masters, cfg, toks).logits,
                       forward(served, cfg, toks).logits)


def test_remat_refuses_an_unknown_policy(model):
    _, tcfg, jparams, toks = model
    cfg = dataclasses.replace(tcfg, remat="some")
    params = _port_params(jparams, cfg)
    with pytest.raises(ValueError, match="remat"):
        loss_fn(params, cfg, t(toks[:, :-1]), t(toks[:, 1:]))


# ------------------------------------------------------ K4 under autograd

def test_k4_function_matches_jax_vjp_on_the_cpu():
    """``ops.attention`` (K4's Function: the plain forward on the CPU, the
    backward through ``attention_ref``) against ``jax.vjp`` of the
    reference ``flash_attention`` (Pallas interpret), (1, 4, 256, 32) with
    two query heads per KV head, causal."""
    g = np.random.default_rng(3)
    q = g.standard_normal((1, 4, 256, 32)).astype(np.float32)
    k = g.standard_normal((1, 2, 256, 32)).astype(np.float32)
    v = g.standard_normal((1, 2, 256, 32)).astype(np.float32)
    up = g.standard_normal((1, 4, 256, 32)).astype(np.float32)
    @jax.jit
    def fwd_vjp(q, k, v, up):
        out, vjp = jax.vjp(lambda a, b, c: jax_flash.flash_attention(
            a, b, c, 0.0, True, 0, 256, 256, True), q, k, v)
        return out, vjp(up)

    out, want = fwd_vjp(q, k, v, up)
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    ops.reset_launch_counts()
    got = ops.attention(tq, tk, tv, causal=True)
    close(got, out, **K4_TOL)
    got.backward(t(up))
    for name, a, w in zip("qkv", (tq, tk, tv), want):
        close(a.grad, w, err_msg=f"d{name}", **K4_TOL)
    assert ops.launch_counts()["flash_attention"] == 0


# -------------------------------------------------------------- optim

def test_schedule_matches_jax():
    for cfg in (dict(warmup_steps=10, total_steps=100),
                dict(warmup_steps=0, total_steps=5, min_lr_frac=0.0),
                dict(warmup_steps=3, total_steps=3)):
        jcfg, tcfg = JaxAdamWConfig(**cfg), AdamWConfig(**cfg)
        steps = np.array([0, 1, 2, 3, 5, 10, 11, 57, 100, 150], np.int32)
        want = jax.jit(jax.vmap(lambda s: jax_schedule(jcfg, s)))(steps)
        for step, w in zip(steps, np.asarray(want)):
            got = schedule(tcfg, torch.tensor(step))
            assert got.dtype == torch.float32
            close(got, w, rtol=1e-7, atol=0, err_msg=f"{cfg} {step}")


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    """Clipping (max_norm 1, below the norm) and no clipping (100): the
    port scales the gradients in place."""
    g = np.random.default_rng(4)
    tree = {"a": g.standard_normal((5, 7)).astype(np.float32),
            "b": [g.standard_normal(11).astype(np.float32) for _ in range(2)]}
    want, want_norm = jax.jit(jax_clip, static_argnums=1)(tree, max_norm)
    mine = {"a": t(tree["a"]), "b": [t(x) for x in tree["b"]]}
    got, norm = clip_by_global_norm(mine, max_norm)
    assert got["a"] is mine["a"]
    close(norm, want_norm, rtol=1e-6, atol=0)
    close(global_norm(mine), min(float(want_norm), max_norm), rtol=1e-6,
          atol=0)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        close(a, b, rtol=1e-6, atol=0)


def test_adamw_update_matches_jax_on_the_same_gradients():
    """Two AdamW updates at the default config (eps 1e-8, clipping at 1
    active) given the same gradients: parameters, m and v against the
    reference's. They differ only where a·x + y rounds once in the port
    (``alpha=``) and twice in the reference: the parameters by at most one
    float32 spacing, m and v by rtol 1e-6."""
    g = np.random.default_rng(6)
    shapes = {"a": (40, 30), "b": (7,)}
    params = {k: g.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: g.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    cfg = dict(warmup_steps=1, total_steps=10)
    jupdate = jax.jit(lambda gr, st, p: jax_adamw_update(
        JaxAdamWConfig(**cfg), gr, st, p))
    jp, jst = params, jax_init_adamw(params)
    tp = {k: t(v) for k, v in params.items()}
    tst = init_adamw(tp)
    for gr in grads:
        jp, jst, jm = jupdate(gr, jst, jp)
        tp, tst, tm = adamw_update(AdamWConfig(**cfg),
                                   {k: t(v) for k, v in gr.items()}, tst, tp)
        close(tm["grad_norm"], jm["grad_norm"], rtol=1e-6, atol=0)
        close(tm["lr"], jm["lr"], rtol=1e-7, atol=0)
    for k in shapes:
        w = np.asarray(jp[k])
        close(tp[k], w, rtol=0, atol=np.spacing(np.abs(w)).max())
        close(tst.m[k], jst.m[k], rtol=1e-6, atol=1e-9)
        close(tst.v[k], jst.v[k], rtol=1e-6, atol=1e-12)
    assert int(tst.step) == 2


def test_compress_and_decompress_match_jax_exactly():
    """Two rounds of int8 error feedback: q, the scales, the residuals and
    the decompressed gradients equal the reference's bit for bit (one
    float32 division and round-half-to-even on each side)."""
    g = np.random.default_rng(5)
    grads = [{"w": g.standard_normal((33, 9)).astype(np.float32),
              "z": np.zeros(4, np.float32)} for _ in range(2)]
    jst = jax_init_compression(jax.tree.map(jnp.asarray, grads[0]))
    tst = init_compression({k: t(v) for k, v in grads[0].items()})
    for gr in grads:
        # eager, as jit lets XLA fuse g + e − q·scale into one rounding
        jq, js, jst = jax_compress(jax.tree.map(jnp.asarray, gr), jst)
        tq, ts, tst = compress({k: t(v) for k, v in gr.items()}, tst)
        for k in gr:
            assert tq[k].dtype == torch.int8
            np.testing.assert_array_equal(n(tq[k]), np.asarray(jq[k]))
            np.testing.assert_array_equal(n(ts[k]), np.asarray(js[k]))
            np.testing.assert_array_equal(n(tst.error[k]),
                                          np.asarray(jst.error[k]))
            np.testing.assert_array_equal(
                n(decompress(tq, ts)[k]),
                np.asarray(jax_decompress(jq, js)[k]))


# --------------------------------------------------------- train step

@pytest.mark.parametrize("micro,comp", [(1, False), (2, True)])
def test_two_train_steps_match_jax(model, micro, comp):
    """Two ``make_train_step`` steps on one batch: parameters, m, v, the
    step, lr, the gradient norm and the loss against the reference's
    (``num_microbatches=2`` with ``compress_grads=True`` in the second
    cell). The port updates in place and keeps no ``.grad``."""
    jcfg, tcfg, jparams, toks = model
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jstep = jax.jit(jax_make_train_step(
        jcfg, JaxAdamWConfig(**OPT), num_microbatches=micro,
        compress_grads=comp))
    jo, jc = jax_init_train_state(jcfg, jparams, compress_grads=comp)
    jp = jparams
    tstep = make_train_step(tcfg, AdamWConfig(**OPT), num_microbatches=micro,
                            compress_grads=comp)
    tp = _port_params(jparams, tcfg)
    to, tc = init_train_state(tcfg, tp, compress_grads=comp)
    first = tp["layers"][0]["attn"]["wq"]
    for _ in range(2):
        jout = jstep(jp, jo, jc, jax.tree.map(jnp.asarray, batch))
        jp, jo, jc = jout.params, jout.opt_state, jout.comp_state
        tout = tstep(tp, to, tc, {k: t(v) for k, v in batch.items()})
        tp, to, tc = tout.params, tout.opt_state, tout.comp_state
        for key, rtol in (("lr", 1e-7), ("grad_norm", 1e-5), ("loss", 1e-6)):
            close(tout.metrics[key], jout.metrics[key], rtol=rtol, atol=0,
                  err_msg=key)
    assert int(to.step) == int(jo.step) == 2
    assert tp["layers"][0]["attn"]["wq"] is first
    assert all(p.grad is None and not p.requires_grad
               for p in tree_leaves(tp))
    flips = FLIPS if comp else 0.0
    pairs = [("params", tp, jp), ("m", to.m, jo.m), ("v", to.v, jo.v)]
    if comp:
        pairs.append(("error", tc.error, jc.error))
    for what, got, want in pairs:
        _assert_trees_close(_stacked(got), jax.tree.map(np.asarray, want),
                            what, STEP_TOL[what], flips)


def test_train_step_refuses_embeddings_front_ends():
    """The vision front end trains from embeddings since item 12.3b:
    ``make_train_step`` takes pixtral's batch of ``embeds`` and ``labels``
    (tests/test_torch_train_families.py holds it to the reference), the
    token table that the loss does not reach gets a zero gradient (so its
    moments stay zero), and a batch without embeddings is refused."""
    cfg = dataclasses.replace(get_config("pixtral-12b"), **dict(
        OVER, use_pallas=False))
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=cfg.param_dtype)
    opt, comp = init_train_state(cfg, params)
    step = make_train_step(cfg, AdamWConfig(**OPT))
    g = torch.Generator().manual_seed(1)
    batch = {"embeds": torch.randn((B, S, cfg.d_model), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    out = step(params, opt, comp, batch)
    assert np.isfinite(float(out.metrics["loss"]))
    assert float(out.metrics["grad_norm"]) > 0
    assert not out.opt_state.m["embed"]["table"].any()
    assert not out.opt_state.v["embed"]["table"].any()
    assert out.opt_state.m["unembed"]["table"].abs().max() > 0
    with pytest.raises(KeyError, match="embeds"):
        step(params, opt, comp, {"tokens": batch["labels"],
                                 "labels": batch["labels"]})
