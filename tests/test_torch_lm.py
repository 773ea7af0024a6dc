"""The port's dense LM (``repro_torch.models``, ``repro_torch.runtime``)
against the JAX package on the CPU.

Small configs of three dense architectures (4 layers, d_model 128,
float32): phi4-mini-3.8b with ``use_pallas`` (the JAX side runs its Pallas
flash kernel in interpret mode, the port K4's plain version), chatglm3-6b
(half rotary, 16 query heads over one KV head, its full config's group)
and gemma2-2b (attention and final softcaps, alternating local windows
shortened to 8 so that they mask at these lengths, post-norms; the plain
branches). Weights: the port's ``init_model`` (the reference's
initialisers, seed 0) carried into the reference's tree, which the JAX
functions take as they are, and back through ``params_from_reference``
(tests/_torch_families.py; the JAX ``init_model`` compiles for seconds an
arch, and ``test_init_model_matches_the_parameter_count`` holds its
tree's size); tokens from numpy. One phi4-mini forward runs in bfloat16,
the chip cell's dtype, with its own tolerance.

Tolerance: the two packages compute the same float32 functions with sums
in different orders. The largest logit differences measured here are
4.8e-6 (forward) and 3.8e-6 (decode) on logits of up to 9.6 in magnitude;
``LOGIT_TOL`` = 1e-4 leaves a margin of more than 20.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import close, n, t
from _torch_families import reference_tree
from repro.configs import get_config as jax_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_decode_state as jax_decode_state
from repro.models import init_model as jax_init_model
from repro.models import layers as jl
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_model, loss_fn, params_from_reference)
from repro_torch.models import layers as tl
from repro_torch.models.transformer import _embed_tokens
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Request, ServeEngine, make_train_step

LOGIT_TOL = dict(rtol=0, atol=1e-4)
F32 = dict(rtol=1e-6, atol=1e-6)
ARCHS = ["phi4-mini-3.8b", "chatglm3-6b", "gemma2-2b"]
S = 256


def _overrides(name: str) -> dict:
    """The JAX smoke tests' reduction (tests/test_models_smoke.py), with
    chatglm3 keeping its group of 16 and gemma2 a window of 8."""
    full = jax_config(name)
    over = dict(n_layers=4, d_model=128, vocab_size=512,
                vocab_pad_multiple=128, dtype="float32", n_heads=4,
                n_kv_heads=max(1, full.n_kv_heads * 4 // full.n_heads),
                d_ff=256, head_dim=32)
    if name == "phi4-mini-3.8b":
        over["use_pallas"] = True
    if name == "chatglm3-6b":
        over.update(n_heads=16, n_kv_heads=1)
    if name == "gemma2-2b":
        over["local_window"] = 8
    return over


@functools.cache
def _model(name: str):
    """(JAX cfg, port cfg, JAX params, port params) of a small config."""
    over = _overrides(name)
    jcfg = dataclasses.replace(jax_config(name), **over)
    tcfg = dataclasses.replace(get_config(name), **over)
    tree = reference_tree(init_model(tcfg, device="cpu"))
    tparams = params_from_reference(tree, tcfg, device="cpu")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tparams


def _tokens(cfg, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ----------------------------------------------------------------- layers

def test_rmsnorm_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 5, 64)).astype(
        np.float32)
    scale = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    want = jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = tl.rmsnorm({"scale": t(scale)}, t(x), 1e-5)
    close(got, want, **F32)


def test_partial_rope_matches_jax():
    """rotary_frac 0.5: the first half of each head rotates as interleaved
    pairs, the rest passes; positions per batch row and shared."""
    x = np.random.default_rng(2).standard_normal((2, 7, 3, 32)).astype(
        np.float32)
    pos_b = np.stack([np.arange(7), np.arange(7) + 40]).astype(np.int32)
    for pos in (pos_b, np.arange(7, dtype=np.int32)):
        jc, js = jl.rope_frequencies(32, 0.5, 10_000.0, jnp.asarray(pos))
        tc, ts = tl.rope_frequencies(32, 0.5, 10_000.0, t(pos))
        close(tc, jc, **F32)
        close(tl.apply_rope(t(x), tc, ts),
              jl.apply_rope(jnp.asarray(x), jc, js), **F32)
        assert np.array_equal(n(tl.apply_rope(t(x), tc, ts))[..., 16:],
                              x[..., 16:])


def test_bf16_rmsnorm_and_rope_match_jax_bitwise():
    """In bfloat16 both compute in float32 and round once at the end, so
    the port's outputs equal JAX's bit for bit; rounding the norm's scale
    or the RoPE tables to bfloat16 first changes 12–33 % of them."""
    bf = lambda a: t(a).to(torch.bfloat16)
    jbf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    g = np.random.default_rng(8)
    x = (4 * g.standard_normal((2, 7, 3, 32))).astype(np.float32)
    scale = g.standard_normal(32).astype(np.float32)
    want = jl.rmsnorm({"scale": jnp.asarray(scale)}, jbf(x), 1e-5)
    got = tl.rmsnorm({"scale": t(scale)}, bf(x), 1e-5)
    assert got.dtype == torch.bfloat16
    close(got.float(), jnp.asarray(want, jnp.float32), rtol=0, atol=0)
    pos = np.stack([np.arange(7), np.arange(7) + 40]).astype(np.int32)
    jc, js = jl.rope_frequencies(32, 0.5, 10_000.0, jnp.asarray(pos))
    tc, ts = tl.rope_frequencies(32, 0.5, 10_000.0, t(pos))
    got = tl.apply_rope(bf(x), tc, ts)
    assert got.dtype == torch.bfloat16
    close(got.float(), jnp.asarray(jl.apply_rope(jbf(x), jc, js),
                                   jnp.float32), rtol=0, atol=0)


@pytest.mark.parametrize("activation", ["silu", "gelu_tanh"])
def test_gated_mlp_matches_jax(activation):
    g = np.random.default_rng(3)
    w = {k: (g.standard_normal(s) / 8).astype(np.float32) for k, s in
         [("w_up", (64, 96)), ("w_gate", (64, 96)), ("w_down", (96, 64))]}
    x = g.standard_normal((2, 5, 64)).astype(np.float32)
    want = jl.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
                  activation=activation)
    got = tl.mlp({k: t(v) for k, v in w.items()}, t(x),
                 activation=activation)
    close(got, want, rtol=1e-5, atol=1e-6)


def test_embedding_scale_is_cast_to_the_activation_dtype():
    """√3072 = 55.43 is 55.5 in bfloat16, as the reference multiplies."""
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"), vocab_size=8,
                              vocab_pad_multiple=8)
    params = {"embed": {"table": torch.ones((8, 3072),
                                            dtype=torch.bfloat16)}}
    h = _embed_tokens(params, cfg, torch.zeros((1, 1), dtype=torch.int32))
    assert h.dtype == torch.bfloat16
    assert float(h[0, 0, 0]) == 55.5


# ---------------------------------------------------------------- forward

@functools.cache
def _jax_logits(name: str) -> np.ndarray:
    jcfg, _, jparams, _ = _model(name)
    toks = _tokens(jcfg, (1, S), seed=4)
    fwd = jax.jit(jax_forward, static_argnums=1)
    return np.asarray(fwd(jparams, jcfg, jnp.asarray(toks)).logits)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_match_jax(name):
    _, tcfg, _, tparams = _model(name)
    ops.reset_launch_counts()
    got = forward(tparams, tcfg, t(_tokens(tcfg, (1, S), seed=4))).logits
    assert got.dtype == torch.float32
    assert got.shape == (1, S, tcfg.padded_vocab)
    close(got, _jax_logits(name), **LOGIT_TOL)
    assert ops.launch_counts()["flash_attention"] == 0


def test_bf16_forward_matches_jax():
    """The chip cell's arithmetic at a small size: phi4-mini in bfloat16
    through the attention kernel's route (JAX: Pallas interpret; the port:
    K4's plain version), the JAX float32 weights cast to bfloat16 once by
    ``params_from_reference`` where JAX casts them at every use, the
    embedding scale, RMSNorm and RoPE cast back to bfloat16. The two sum
    in different orders, so a bf16 rounding may flip; the tolerance is four
    bf16 spacings (2⁻⁷ of the power of two below) of the largest logit.
    Measured: 0.0625, one spacing, against a largest logit of 9.56."""
    jcfg, tcfg, jparams, _ = _model("phi4-mini-3.8b")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    assert tparams["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    toks = _tokens(tcfg, (1, S), seed=4)
    fwd = jax.jit(jax_forward, static_argnums=1)
    want = np.asarray(fwd(jparams, jcfg, jnp.asarray(toks)).logits)
    got = forward(tparams, tcfg, t(toks)).logits
    assert got.dtype == torch.float32
    spacing = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    close(got, want, rtol=0, atol=4 * spacing)


# ----------------------------------------------------------------- decode

@pytest.mark.parametrize("name", ["chatglm3-6b", "gemma2-2b"])
def test_decode_steps_match_jax(name):
    """16 steps of batch 2 (gemma2's window of 8 masks from step 9 on)."""
    jcfg, tcfg, jparams, tparams = _model(name)
    toks = _tokens(tcfg, (2, 16), seed=5)
    jstep = jax.jit(jax_decode_step, static_argnums=1)
    jst = jax_decode_state(jcfg, 2, 32)
    tst = init_decode_state(tcfg, 2, 32, device="cpu")
    for i in range(16):
        jlog, jst = jstep(jparams, jcfg, jnp.asarray(toks[:, i:i + 1]), jst)
        tlog, tst = decode_step(tparams, tcfg, t(toks[:, i:i + 1]), tst)
        close(tlog, jlog, **LOGIT_TOL)
    assert tst.length == 16


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "gemma2-2b"])
def test_decode_matches_forward(name):
    """The JAX package's test_decode_matches_forward, on the port alone:
    16 decode steps give the forward's logits (phi4 through K4's plain
    version, gemma2 through the softcapped windowed branch)."""
    _, tcfg, _, tparams = _model(name)
    toks = t(_tokens(tcfg, (2, 16), seed=6))
    full = forward(tparams, tcfg, toks).logits
    st = init_decode_state(tcfg, 2, 64, device="cpu")
    outs = []
    for i in range(16):
        lg, st = decode_step(tparams, tcfg, toks[:, i:i + 1], st)
        outs.append(lg[:, 0])
    err = float((torch.stack(outs, dim=1) - full).abs().max())
    assert err < 2e-2, f"decode/forward mismatch {err}"


# ---------------------------------------------------------------- serving

def _recording(step_fn, log):
    def step(params, tokens, caches):
        logits, caches = step_fn(params, tokens, caches)
        log.append((n(tokens).copy(), n(logits)[:, -1].copy()))
        return logits, caches
    return step


def test_serve_engine_matches_jax():
    """3 requests on 2 slots, max_len 64, 4 new tokens: both engines feed
    the same tokens at every step, their logits agree, and the port
    generates the JAX engine's greedy tokens. A step where the JAX logits'
    top-2 gap is below the tolerance could pick either token, so the
    comparison stops at the first such step (none occurs with these
    seeds: the test asserts that too, so a change that makes one appear
    is seen)."""
    jcfg, tcfg, jparams, tparams = _model("phi4-mini-3.8b")
    prompts = [_tokens(tcfg, (k,), seed=10 + k) for k in (5, 9, 3)]
    jeng = JaxServeEngine(jcfg, jparams, slots=2, max_len=64)
    teng = ServeEngine(tcfg, tparams, slots=2, max_len=64)
    jlog, tlog = [], []
    jeng.step_fn = _recording(jeng.step_fn, jlog)
    teng.step_fn = _recording(teng.step_fn, tlog)
    for uid, p in enumerate(prompts):
        jeng.submit(JaxRequest(uid=uid, prompt=p, max_new_tokens=4))
        teng.submit(Request(uid=uid, prompt=p, max_new_tokens=4))
    jdone = {r.uid: r.generated for r in jeng.run()}
    tdone = {r.uid: r.generated for r in teng.run()}
    assert len(tlog) == len(jlog) == teng.steps
    ties = []
    for step, ((jt, jl_), (tt, tl_)) in enumerate(zip(jlog, tlog)):
        np.testing.assert_array_equal(tt, jt, err_msg=f"step {step}")
        close(tl_, jl_, **LOGIT_TOL)
        top2 = np.sort(jl_, axis=-1)[:, -2:]
        if (top2[:, 1] - top2[:, 0]).min() < LOGIT_TOL["atol"]:
            ties.append(step)
            break
    assert not ties, f"near-tie at step {ties[0]}"
    assert tdone == jdone
    assert sorted(tdone) == [0, 1, 2]
    assert all(len(g) == 4 for g in tdone.values())


def test_serve_cli_runs_on_the_cpu(capsys):
    done = serve_cli.main(["--arch", "phi4-mini-3.8b", "--device", "cpu",
                           "--requests", "2", "--slots", "2", "--max-new",
                           "2", "--max-len", "64"])
    assert len(done) == 2 and all(len(r.generated) == 2 for r in done)
    assert "served 2/2 requests" in capsys.readouterr().out


# ------------------------------------------------------------- the model

def test_init_model_matches_the_parameter_count():
    jcfg, tcfg, _, _ = _model("gemma2-2b")
    mine = init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tree = jax.eval_shape(lambda k: jax_init_model(jcfg, k),
                          jax.random.key(0))
    ref_count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    count = lambda p: sum(count(v) if isinstance(v, (dict, list)) else
                          v.numel() for v in (p.values() if isinstance(
                              p, dict) else p))
    # n_params leaves out the final norm and gemma2's post-norms
    uncounted = (2 * tcfg.n_layers + 1) * tcfg.d_model
    assert count(mine) == ref_count == tcfg.n_params() + uncounted
    wq = mine["layers"][0]["attn"]["wq"]
    assert wq.dtype == torch.float32 and float(wq.abs().max()) <= \
        3 * tcfg.d_model ** -0.5


def test_unported_families_and_modes_name_their_roadmap_item():
    """Training is ported for every family since item 12.3b: ``loss_fn``
    runs for the six archs that it once refused (the moe, ssm and hybrid
    families, and the vision / audio archs from embeddings, musicgen's
    labels over its 4 codebooks) at a tiny cut of the launcher's
    reduction, and ``make_train_step`` builds for each; a family that the
    model does not know is still refused, by name, in both."""
    from repro_torch.launch.train import build_small_cfg
    from repro_torch.models import init_model, loss_fn
    g = torch.Generator().manual_seed(0)
    for arch in ("deepseek-moe-16b", "llama4-scout-17b-a16e", "mamba2-780m",
                 "zamba2-7b", "pixtral-12b", "musicgen-medium"):
        # remat "none": the policies are held in test_torch_train_families
        cfg = build_small_cfg(arch, n_layers=4, d_model=64, n_heads=4,
                              n_kv_heads=2, head_dim=16, d_ff=128,
                              vocab_size=256, remat="none")
        params = init_model(cfg, g, device="cpu")
        if cfg.modality in ("vision", "audio"):
            embeds, tokens = torch.randn((1, 16, 64), generator=g), None
        else:
            embeds, tokens = None, torch.randint(0, 256, (1, 16), generator=g)
        shape = (1, 16, 4) if arch == "musicgen-medium" else (1, 16)
        labels = torch.randint(0, 256, shape, generator=g)
        loss = loss_fn(params, cfg, tokens, labels, embeds=embeds)
        assert loss.shape == () and loss.dtype == torch.float32, arch
        assert 4.0 < float(loss) < 8.0, arch     # about ln 256 = 5.5
        assert callable(make_train_step(cfg, AdamWConfig()))
        other = dataclasses.replace(cfg, family="rnn")
        with pytest.raises(ValueError, match="unknown family 'rnn'"):
            loss_fn(params, other, tokens, labels, embeds=embeds)
        with pytest.raises(ValueError, match="unknown family 'rnn'"):
            make_train_step(other, AdamWConfig())
