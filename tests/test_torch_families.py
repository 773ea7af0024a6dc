"""The port's moe, ssm and hybrid families and the vision / audio front ends
(``repro_torch.models``) against the JAX package on the CPU.

Sizes: the JAX smoke tests' reduction (``tests/test_models_smoke.py``
``small_cfg``: d_model 128, 4 layers, 4 heads of 32, 8 experts top-2,
d_state 16, head_dim 32, chunk 32; zamba2 at 7 layers with the shared
block every 3, so two groups and a tail), float32, S = 64 (two SSD
chunks). Inputs are made with numpy.

Weights: one set for both packages (``tests/_torch_families.py``); the
JAX ``init_model``'s tree is held against the port's here, through
``jax.eval_shape``.

Tolerance: the two packages compute the same float32 functions with sums
in different orders. The largest differences measured here are 8.0e-6
(forward logits, zamba2) on logits of up to 5.0, and 9.5e-7 (the MoE
block's output); ``LOGIT_TOL`` = 1e-4, the dense family's, holds them
with a margin of 12 or more. The MoE dispatch is discontinuous, but no
routing decision of these inputs lies within float32 rounding of
flipping (a flip would show as an error near 1).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import close, n, t
from _torch_families import inputs, model, reference_tree
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_decode_state as jax_decode_state
from repro.models import init_model as jax_init_model
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_model)
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm

LOGIT_TOL = dict(rtol=0, atol=1e-4)
ARCHS = ["deepseek-moe-16b", "mamba2-780m", "zamba2-7b", "pixtral-12b",
         "musicgen-medium"]
S = 64


def _count(p) -> int:
    if isinstance(p, dict):
        return sum(_count(v) for v in p.values())
    if isinstance(p, list):
        return sum(_count(v) for v in p)
    return p.numel()


# ------------------------------------------------------------ the blocks

def _moe_case(name: str, shape, seed: int):
    """A MoE layer's weights (the first of the stack) and an input."""
    jcfg, tcfg, jparams, tparams = model(name)
    x = np.random.default_rng(seed).standard_normal(
        shape + (tcfg.d_model,)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])["moe"]
    return jcfg, tcfg, jp, tparams["layers"][0]["moe"], x


@pytest.mark.parametrize("name,shape", [
    ("deepseek-moe-16b", (2, 64)),      # t = 128: G 16, t_g 8, capacity 3
    ("deepseek-moe-16b", (1, 60)),      # t % 16 != 0: G 1, capacity 19
    ("llama4-scout-17b-a16e", (2, 32)),  # top-1, a shared expert
], ids=["groups16_drops", "one_group", "llama4_top1_shared"])
def test_moe_block_matches_jax(name, shape):
    jcfg, cfg, jp, tp, x = _moe_case(name, shape, seed=1)
    want = jax.jit(jmoe.moe_block, static_argnums=1)(jp, jcfg, jnp.asarray(x))
    got = tmoe.moe_block(tp, cfg, t(x))
    close(got.y, want.y, rtol=0, atol=2e-5)
    close(got.aux_loss, want.aux_loss, rtol=1e-6, atol=0)
    if shape == (2, 64):
        # the GShard drop rule is exercised: some assignment was dropped
        probs = torch.softmax((t(x).reshape(-1, cfg.d_model)
                               @ tp["router"]).float(), dim=-1)
        disp = tmoe.dispatch(probs.reshape(16, 8, cfg.moe.n_experts),
                             cfg.moe.top_k, 3)
        assert not bool(disp.keep.all())


def test_moe_ties_pick_the_lower_expert_first():
    """Equal probabilities rank by expert index, as jax.lax.top_k does."""
    probs = torch.tensor([[[0.1, 0.3, 0.3, 0.3]]])
    disp = tmoe.dispatch(probs, 2, cap=4)
    assert disp.expert.tolist() == [[1, 2]]
    _, idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert n(idx).reshape(-1).tolist() == [1, 2]


def _ssm_case():
    """zamba2's third SSM layer."""
    jcfg, tcfg, jparams, tparams = model("zamba2-7b")
    jp = jax.tree.map(lambda a: a[2], jparams["layers"])["ssm"]
    return jcfg, tcfg, jp, tparams["layers"][2]["ssm"]


def test_ssm_block_matches_jax():
    """Three chunks of 32 (the inter-chunk recurrence runs), two groups."""
    jcfg, cfg, jp, tp = _ssm_case()
    u = np.random.default_rng(2).standard_normal((2, 96, 128)).astype(
        np.float32)
    want = jax.jit(jssm.ssm_block, static_argnums=1)(jp, jcfg, jnp.asarray(u))
    close(tssm.ssm_block(tp, cfg, t(u)), want, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="must divide chunk"):
        tssm.ssm_block(tp, cfg, t(u[:, :40]))


def test_ssm_decode_step_matches_jax():
    """Three recurrent steps from a non-zero state; the port's state is
    updated in place."""
    jcfg, cfg, jp, tp = _ssm_case()
    g = np.random.default_rng(3)
    dm = tssm.ssm_dims(cfg)
    conv = g.standard_normal((2, dm["conv_kernel"] - 1, dm["conv_dim"])
                             ).astype(np.float32)
    ssm = g.standard_normal((2, dm["nh"], dm["head_dim"], dm["d_state"])
                            ).astype(np.float32)
    jst = jssm.SSMState(jnp.asarray(conv), jnp.asarray(ssm))
    tst = tssm.SSMState(t(conv), t(ssm))
    jstep = jax.jit(jssm.ssm_decode_step, static_argnums=1)
    for _ in range(3):
        u = g.standard_normal((2, 1, 128)).astype(np.float32)
        jy, jst = jstep(jp, jcfg, jnp.asarray(u), jst)
        ty, out = tssm.ssm_decode_step(tp, cfg, t(u), tst)
        assert out.ssm is tst.ssm and out.conv is tst.conv
        close(ty, jy, rtol=0, atol=2e-5)
        close(tst.conv, jst.conv, rtol=0, atol=2e-5)
        close(tst.ssm, jst.ssm, rtol=0, atol=2e-5)


# ------------------------------------------------------------ the model

@functools.cache
def _jax_forward(name: str, dtype: str = "float32"):
    jcfg, _, jparams, _ = model(name, dtype)
    fwd = jax.jit(jax_forward, static_argnums=1)
    out = fwd(jparams, jcfg, **{k: jnp.asarray(v) for k, v in
                                inputs(jcfg, 2, S, seed=4).items()})
    return np.asarray(out.logits), float(out.aux_loss)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_jax(name):
    """Logits (and deepseek's MoE aux loss): token ids, or embeddings for
    pixtral and musicgen (musicgen through its four codebook heads)."""
    _, tcfg, _, tparams = model(name)
    want, aux = _jax_forward(name)
    got = forward(tparams, tcfg, **{k: t(v) for k, v in
                                    inputs(tcfg, 2, S, seed=4).items()})
    shape = (2, S) + ((tcfg.num_codebooks,) if tcfg.num_codebooks > 1
                      else ()) + (tcfg.padded_vocab,)
    assert got.logits.shape == shape and got.logits.dtype == torch.float32
    close(got.logits, want, **LOGIT_TOL)
    close(got.aux_loss, aux, rtol=1e-6, atol=0)
    assert (aux > 0) == (tcfg.family == "moe")


@pytest.mark.parametrize("name", ["pixtral-12b", "musicgen-medium"])
def test_decode_steps_match_jax(name):
    """8 steps of batch 2 from embeddings (musicgen's logits through its
    codebook heads). The token-fed families' decode steps are held in
    tests/test_torch_families_serve.py, on the JAX engine's own step."""
    jcfg, tcfg, jparams, tparams = model(name)
    x = inputs(tcfg, 2, 8, seed=5)
    key = next(iter(x))
    jstep = jax.jit(jax_decode_step, static_argnums=1)
    jst = jax_decode_state(jcfg, 2, 16)
    tst = init_decode_state(tcfg, 2, 16, device="cpu")
    for i in range(8):
        step = x[key][:, i:i + 1]
        if key == "embeds":
            jlog, jst = jstep(jparams, jcfg, None, jst,
                              embeds=jnp.asarray(step))
            tlog, tst = decode_step(tparams, tcfg, None, tst, embeds=t(step))
        else:
            jlog, jst = jstep(jparams, jcfg, jnp.asarray(step), jst)
            tlog, tst = decode_step(tparams, tcfg, t(step), tst)
        close(tlog, jlog, **LOGIT_TOL)
    assert tst.length == 8


def test_bf16_zamba2_forward_matches_jax():
    """zamba2 in bfloat16 (the chip cell's dtype): both packages round at
    the reference's places (the SSD's Gram, decay and diagonal term, the
    convolution's products and sums), but not in one order, so a bf16
    rounding may flip and travel through 7 SSM layers and two uses of the
    shared block. The tolerance is eight bf16 spacings (2⁻⁷ of the power of
    two below) of the largest logit. Measured: 0.0625, two spacings,
    against a largest logit of 4.2."""
    _, tcfg, _, tparams = model("zamba2-7b", "bfloat16")
    assert tparams["layers"][0]["ssm"]["in_proj"].dtype == torch.bfloat16
    assert tparams["layers"][0]["ssm"]["D"].dtype == torch.float32
    want, _ = _jax_forward("zamba2-7b", "bfloat16")
    got = forward(tparams, tcfg, **{k: t(v) for k, v in
                                    inputs(tcfg, 2, S, seed=4).items()})
    spacing = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    close(got.logits, want, rtol=0, atol=8 * spacing)


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-780m",
                                  "zamba2-7b"])
def test_init_model_matches_the_reference_tree_and_count(name):
    """The port's ``init_model`` gives the reference's tree (every leaf's
    path and shape, the layers stacked) and the parameter count that
    ``n_params`` books, less what it leaves out: the final norm, and per
    SSM layer its conv bias, ``dt_bias`` and the second of the two norms
    it books (an SSM layer has one)."""
    jcfg, tcfg, _, _ = model(name)
    mine = init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(lambda k: jax_init_model(jcfg, k),
                          jax.random.key(0))
    tree = reference_tree(mine)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        here = tree
        for k in path:
            here = here[k.key]
        assert here.shape == leaf.shape, jax.tree_util.keystr(path)
    uncounted = tcfg.d_model
    if tcfg.family in ("ssm", "hybrid"):
        dm = tssm.ssm_dims(tcfg)
        uncounted += tcfg.n_layers * (dm["conv_dim"] + dm["nh"]
                                      - tcfg.d_model)
    assert _count(mine) == tcfg.n_params() + uncounted
    assert mine["layers"][0].get("ssm", {}).get("D", torch.ones(1)).dtype \
        == torch.float32
