"""Nyström-RLS attention in the port (``repro_torch.core.attention_nystrom``
and the LM paths through it) against the JAX package on the CPU.

The attention problems are tests/test_attention_nystrom.py's sizes (B = 2,
H = 4, S = 256, D = 32) drawn with numpy; where a selection is compared,
the reference's landmarks are injected into the port, and separately the
port's own selection is held wherever the scores decide it. The models are
the JAX smoke tests' reductions (tests/test_models_smoke.py ``small_cfg``)
with ``attn_approx="nystrom_rls"``: phi4-mini (landmarks 32, recent 8),
chatglm3 (landmarks 16, recent 4, as ``test_nystrom_decode_runs``) and
zamba2; weights from the port's ``init_model`` carried into the reference's
tree (tests/_torch_families.py). The JAX sides' jitted functions are shared
through module fixtures.

Tolerances, each beside the largest difference measured here:
  * scores: rtol 2e-4, atol 1e-6, the score tolerance of
    tests/test_kernels_pallas.py (measured 5.3e-6 relative);
  * attention outputs, float32: atol 1e-5, the JAX suite's own bar for
    p = s (measured 2.4e-7 causal, 8.9e-8 non-causal, 2.4e-7 at p = s);
    bfloat16: one bf16 spacing of the largest output (measured 0: the
    port rounds where the reference rounds, the scale to 11.3125 included);
  * logits: 1e-4, tests/test_torch_lm.py's ``LOGIT_TOL`` (measured below
    1e-5); the loss rtol 1e-6 and every gradient atol 5e-7, tests/
    test_torch_train.py's (measured in the test's message on failure).

Three faults of the reference that the port keeps (ROADMAP §3): R7, the
frozen decode landmarks are never selected by score and a recent position
that is also a landmark is read twice; R8, ``keep_recent`` pins the
buffer's last slots, not the last tokens written; R9, on a partly filled
cache the float32 factorisation of the key scores can fail, giving NaN
scores, which rank above +inf so the pins drop out. Each is pinned by a
test that runs the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from _torch_common import F32_SCORE_TOL, close, n, t
from _torch_families import port_config, reference_tree
from test_models_smoke import small_cfg

from repro.core import attention_nystrom as jan
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_decode_state as jax_decode_state
from repro.models import loss_fn as jax_loss_fn
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeEngine as JaxServeEngine
from repro_torch.core import attention_nystrom as tan
from repro_torch.launch import serve as serve_cli
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_model, loss_fn, params_from_reference)
from repro_torch.models import attention as tattn
from repro_torch.runtime import Request, ServeEngine

ATTN_TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
LOSS_TOL = dict(rtol=1e-6, atol=0)
GRAD_ATOL = 5e-7
B, H, S, D = 2, 4, 256, 32
NYSTROM = dict(attn_approx="nystrom_rls")

# the reference's functions under jit (about 4x cheaper than eagerly here)
jax_scores = jax.jit(jan.key_rls_scores, static_argnums=1)
jax_attention = jax.jit(jan.nystrom_attention,
                        static_argnames=("num_landmarks", "causal"))
jax_compress = jax.jit(jan.rls_kv_compression, static_argnums=2,
                       static_argnames="keep_recent")
jax_step = jax.jit(jax_decode_step, static_argnums=1)


def _qkv(seed: int = 0, s: int = S) -> tuple[np.ndarray, ...]:
    g = np.random.default_rng(seed)
    q = (0.5 * g.standard_normal((B, H, s, D))).astype(np.float32)
    k = (0.5 * g.standard_normal((B, H, s, D))).astype(np.float32)
    v = g.standard_normal((B, H, s, D)).astype(np.float32)
    return q, k, v


@pytest.fixture(scope="module")
def problem():
    """q, k, v and the reference's scores (p_sketch 64) and causal output
    at 32 landmarks, with the landmarks it selected."""
    q, k, v = _qkv()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out = jax_attention(jq, jk, jv, num_landmarks=32, causal=True)
    return dict(q=q, k=k, v=v, scores=n(jax_scores(jk, 64)),
                out=n(out.out), lm=n(out.landmarks))


def _model(name: str, **over):
    """(JAX cfg, port cfg, JAX params, port params): the smoke reduction
    with Nyström-RLS attention, the port's seed-0 weights in both."""
    jcfg = small_cfg(name, **NYSTROM, **over)
    tcfg = port_config(jcfg)
    tree = reference_tree(init_model(tcfg, device="cpu"))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_reference(tree, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def chatglm3():
    return _model("chatglm3-6b", nystrom_landmarks=16, rls_keep_recent=4)


@pytest.fixture(scope="module")
def phi4():
    # no remat: the gradient cell holds the attention's gradients, which
    # tests/test_torch_train.py holds under each policy; the reference's
    # gradient compiles in half the time without it
    return _model("phi4-mini-3.8b", remat="none")


def _tokens(cfg, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------ key scores

def test_key_rls_scores_match_reference(problem):
    got = tan.key_rls_scores(t(problem["k"]), 64)
    assert got.dtype == torch.float32 and got.shape == (B, H, S)
    close(got, problem["scores"], **F32_SCORE_TOL)


def test_scores_lie_in_range_and_flag_an_outlier_key():
    """Scores in [0, 1] (bf16 keys scored in float32), and a key far from
    the others scores highest, as tests/test_attention_nystrom.py holds
    for the reference."""
    k = (0.05 * np.random.default_rng(1).standard_normal(
        (1, 1, 128, 16))).astype(np.float32)
    k[0, 0, 77] = 3.0
    for got in (tan.key_rls_scores(t(k), 64),
                tan.key_rls_scores(t(k).bfloat16(), 64)):
        assert got.dtype == torch.float32
        assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
        assert int(got[0, 0].argmax()) == 77


def test_select_landmarks_matches_top_k_on_ties_inf_and_nan():
    """NaN ranks above +inf, equal scores go to the lower index, as
    ``lax.top_k`` ranks them (``torch.topk`` orders the +inf pair the
    other way on this vector); then sorted."""
    probe = np.array([0.5, np.nan, np.inf, 0.5, np.nan, 0.1, np.inf],
                     np.float32)
    g = np.random.default_rng(2)
    ties = np.round(g.uniform(size=(2, 3, 100)), 1).astype(np.float32)
    ties[0, 0, [5, 50]] = np.nan
    ties[0, 1, [7, 70]] = np.inf
    ties[1, 2, :30] = -np.inf
    for scores, p in ((probe, 5), (ties, 10), (ties, 80)):
        want = jnp.sort(jax.lax.top_k(jnp.asarray(scores), p)[1], axis=-1)
        got = tan.select_landmarks(t(scores), p)
        np.testing.assert_array_equal(n(got), n(want))
    np.testing.assert_array_equal(n(tan.select_landmarks(t(probe), 5)),
                                  [0, 1, 2, 4, 6])


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_rls_sparse_attention_matches_reference(problem, dtype):
    """The reference's landmarks injected. In bfloat16 the logits, the
    softmax and ``w·v`` stay in bf16 on both sides."""
    lm = t(problem["lm"])
    if dtype == "float32":
        got = tan.nystrom_attention(t(problem["q"]), t(problem["k"]),
                                    t(problem["v"]), num_landmarks=32,
                                    landmarks=lm)
        close(got.out, problem["out"], **ATTN_TOL)
        return
    jq, jk, jv = (jnp.asarray(problem[x]).astype(jnp.bfloat16)
                  for x in "qkv")
    want = np.asarray(jax_attention(
        jq, jk, jv, num_landmarks=32, landmarks=jnp.asarray(problem["lm"])
    ).out.astype(jnp.float32))
    got = tan.nystrom_attention(*(t(problem[x]).bfloat16() for x in "qkv"),
                                num_landmarks=32, landmarks=lm).out
    assert got.dtype == torch.bfloat16
    spacing = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    close(got.float(), want, rtol=0, atol=spacing)


def test_noncausal_nystrom_matches_reference(problem):
    jq, jk, jv = (jnp.asarray(problem[x]) for x in "qkv")
    want = jax_attention(jq, jk, jv, num_landmarks=64, causal=False)
    got = tan.nystrom_attention(*(t(problem[x]) for x in "qkv"),
                                num_landmarks=64, causal=False,
                                landmarks=t(n(want.landmarks)))
    close(got.out, want.out, **ATTN_TOL)


def test_all_landmarks_give_exact_causal_attention(problem):
    """p = s selects every key: RLS-sparse attention is exact attention,
    held against the reference's ``attention_ref``."""
    q, k, v = (problem[x] for x in "qkv")
    got = tan.nystrom_attention(t(q), t(k), t(v), num_landmarks=S)
    np.testing.assert_array_equal(n(got.landmarks),
                                  np.broadcast_to(np.arange(S), (B, H, S)))
    want = jax.jit(jref.attention_ref, static_argnames="causal")(
        *map(jnp.asarray, (q, k, v)), causal=True)
    close(got.out, want, **ATTN_TOL)


def test_own_selection_matches_where_the_scores_part(problem):
    """landmarks=None: the port selects the reference's landmarks in every
    row whose p-th and (p+1)-th scores (p_sketch 64 = 2p) lie further apart
    than the two packages' scores differ there; the port's output then
    equals the reference's."""
    q, k, v = (problem[x] for x in "qkv")
    got = tan.nystrom_attention(t(q), t(k), t(v), num_landmarks=32)
    mine = n(tan.key_rls_scores(t(k), 64))
    ranked = -np.sort(-problem["scores"], axis=-1)
    margin = ranked[..., 31] - ranked[..., 32]
    decided = margin > np.abs(mine - problem["scores"]).max(-1)
    assert decided.mean() >= 0.5, decided
    same = (n(got.landmarks) == problem["lm"]).all(-1)
    assert same[decided].all()
    close(n(got.out)[decided], problem["out"][decided], **ATTN_TOL)


# ------------------------------------------------------- KV compression

@pytest.mark.parametrize("live", [512, 200], ids=["full", "r8"])
def test_kv_compression_keeps_the_reference_positions(live):
    """A buffer of 512 slots written throughout, and R8: 200 live keys in
    it (the rest zero, as the compressed decode masks them); p = 64, four
    pinned slots — the buffer's last four (508–511), which hold no token
    in the second case, in both packages."""
    slots = 512
    g = np.random.default_rng(3)
    k = np.zeros((1, 2, slots, D), np.float32)
    k[:, :, :live] = 0.5 * g.standard_normal((1, 2, live, D))
    v = g.standard_normal((1, 2, slots, D)).astype(np.float32)
    want = jax_compress(jnp.asarray(k), jnp.asarray(v), 64, keep_recent=4)
    got = tan.rls_kv_compression(t(k), t(v), 64, keep_recent=4)
    assert np.isfinite(n(want.scores)[..., :-4]).all()
    np.testing.assert_array_equal(n(got.positions), n(want.positions))
    close(got.scores, want.scores, **F32_SCORE_TOL)
    close(got.k, want.k, rtol=0, atol=0)
    assert (n(got.positions)[..., -4:] == np.arange(slots - 4, slots)).all()


def test_r9_partly_filled_cache_gives_the_reference_nan_scores():
    """R9: 300 live keys in 1,024 slots (2 heads, D = 64, the rest zero),
    p = 64 at p_sketch 128 with 8 pins. The zeroed keys give identical
    sketch columns, W + 1e-6·I is singular in float32, and the reference's
    Cholesky returns NaN for head 1: all its scores NaN, so it keeps
    positions 0–63 and drops its pins. The port returns NaN where its own
    factorisation fails; torch's ``cholesky_ex`` (its own LAPACK) factors
    head 1, so the port's scores are finite there and it keeps the pins
    (the case is the one measured, not resized)."""
    g = np.random.default_rng(0)
    k = np.zeros((1, 2, 1024, 64), np.float32)
    k[:, :, :300] = g.standard_normal((1, 2, 300, 64))
    v = np.zeros_like(k)
    want = jax_compress(jnp.asarray(k), jnp.asarray(v), 64, keep_recent=8)
    got = tan.rls_kv_compression(t(k), t(v), 64, keep_recent=8)
    wscores, wpos = n(want.scores), n(want.positions)
    assert np.isnan(wscores[0, 1, :1016]).all()
    np.testing.assert_array_equal(wpos[0, 1], np.arange(64))
    gscores, gpos = n(got.scores), n(got.positions)
    assert np.isfinite(gscores[0, 1, :1016]).all()
    # head 0 factors in both, and both keep its pins
    assert np.isfinite(wscores[0, 0, :1016]).all()
    assert np.isfinite(gscores[0, 0, :1016]).all()
    for pos in (gpos[0, 0], wpos[0, 0], gpos[0, 1]):
        assert set(range(1016, 1024)) <= set(pos.tolist())


# -------------------------------------------------------------- decode

@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "deepseek-moe-16b",
                                  "zamba2-7b"])
def test_init_decode_state_freezes_the_reference_landmarks(name):
    """Strided landmarks over max_len, (L, b, hkv, p) int32, for the dense
    and moe families (the moe's layer0 at index 0); none for the hybrid,
    whose shared block scores its cache at every step. The moe family then
    decodes through them (the reference's moe decode step does not run on
    this jax, tests/test_models_smoke.py ``DECODE_STEP_FAILING``)."""
    jcfg = small_cfg(name, **NYSTROM)
    tcfg = port_config(jcfg)
    want = jax_decode_state(jcfg, 3, 80).lm
    st = init_decode_state(tcfg, 3, 80, device="cpu")
    if name == "zamba2-7b":
        assert want is None and st.lm is None
        return
    assert st.lm.dtype == torch.int32
    assert st.lm.shape == (jcfg.n_layers, 3, jcfg.n_kv_heads, 32)
    np.testing.assert_array_equal(n(st.lm), n(want))
    if name == "deepseek-moe-16b":
        params = init_model(tcfg, device="cpu")
        lm = st.lm.clone()
        for i in range(2):
            logits, st = decode_step(params, tcfg, t(_tokens(
                tcfg, (3, 1), seed=i)), st)
            assert bool(torch.isfinite(logits).all())
        assert st.length == 2 and torch.equal(st.lm, lm)


def test_r7_frozen_decode_reads_recent_landmarks_twice():
    """R7 at one layer: at length 1 with landmarks 0, 4, … and r = 4, the
    recency window is max(1 − 4 + 1 + arange(4), 0) = (0, 0, 0, 1), so
    the query reads key 0 four times and key 1 once. The port's output
    equals the reference's and that weighting, not exact attention."""
    jcfg = small_cfg("chatglm3-6b", **NYSTROM, nystrom_landmarks=16,
                     rls_keep_recent=4)
    cfg = port_config(jcfg)
    g = np.random.default_rng(4)
    q = g.standard_normal((2, 4, 1, 32)).astype(np.float32)
    k, v = (g.standard_normal((2, 1, 64, 32)).astype(np.float32)
            for _ in range(2))
    lm = np.broadcast_to(np.arange(16, dtype=np.int32) * 4, (2, 1, 16))
    start = np.zeros(2, np.int32)
    want = jax.jit(jattn._decode_rls_frozen, static_argnums=6)(
        *map(jnp.asarray, (q, k, v)), jnp.int32(1), jnp.asarray(start),
        jnp.asarray(lm), jcfg)
    got = tattn._decode_rls_frozen(t(q), t(k), t(v), 1, t(start), t(lm),
                                   cfg)
    close(got, want, **ATTN_TOL)
    logits = np.einsum("bhd,bsd->bhs", q[:, :, 0], k[:, 0, :2]) / 32 ** 0.5
    w = np.exp(logits) * np.array([4.0, 1.0])
    dup = np.einsum("bhs,bsd->bhd", w / w.sum(-1, keepdims=True), v[:, 0, :2])
    close(n(got)[:, :, 0], dup, **ATTN_TOL)
    exact = tattn._decode_exact(t(q), t(k), t(v), 1, t(start), cfg, 0)
    assert float((got - exact).abs().max()) > 1e-2


def test_frozen_decode_steps_match_reference(chatglm3):
    """chatglm3 (16 query heads over one KV head), landmarks 16, recent 4,
    batch 2 over 64 slots: 20 steps, the first three inside R7's window."""
    jcfg, tcfg, jparams, tparams = chatglm3
    toks = _tokens(tcfg, (2, 20), seed=5)
    jst = jax_decode_state(jcfg, 2, 64)
    tst = init_decode_state(tcfg, 2, 64, device="cpu")
    for i in range(20):
        jlog, jst = jax_step(jparams, jcfg, jnp.asarray(toks[:, i:i + 1]),
                             jst)
        tlog, tst = decode_step(tparams, tcfg, t(toks[:, i:i + 1]), tst)
        close(tlog, jlog, **LOGIT_TOL)
    np.testing.assert_array_equal(n(tst.lm), n(jst.lm))


def test_compressed_decode_on_a_full_cache_matches_reference():
    """zamba2 (the hybrid: no frozen landmarks, its shared block scores its
    whole cache every step), landmarks 32 of 64 slots, recent 8: the same
    random caches in both packages, written through slot 59, then four
    steps that fill the buffer. The reference's scores of every cache are
    finite at the start (outside R9)."""
    jcfg, tcfg, jparams, tparams = _model("zamba2-7b")
    g = np.random.default_rng(6)
    tst = init_decode_state(tcfg, 2, 64, prefill_len=60, device="cpu")
    for part in (tst.kv.k, tst.kv.v):
        part.copy_(t(g.standard_normal(part.shape).astype(np.float32)))
    jst = jax_decode_state(jcfg, 2, 64, prefill_len=60)
    jst = jst._replace(kv=type(jst.kv)(jnp.asarray(n(tst.kv.k)),
                                       jnp.asarray(n(tst.kv.v))))
    live = np.arange(64) < 60
    masked = np.where(live[:, None], n(tst.kv.k), 0.0)
    assert np.isfinite(n(jax_scores(jnp.asarray(masked), 64))).all()
    toks = _tokens(tcfg, (2, 4), seed=7)
    for i in range(4):
        jlog, jst = jax_step(jparams, jcfg, jnp.asarray(toks[:, i:i + 1]),
                             jst)
        tlog, tst = decode_step(tparams, tcfg, t(toks[:, i:i + 1]), tst)
        close(tlog, jlog, **LOGIT_TOL)
    assert tst.lm is None and tst.length == 64


# ------------------------------------------------------- forward, train

def test_forward_logits_match_reference(phi4):
    """phi4-mini (4 query heads over one KV head, so the keys are repeated
    to every head before scoring), 128 tokens: 32 landmarks at p_sketch
    64, every layer through RLS-sparse attention."""
    jcfg, tcfg, jparams, tparams = phi4
    toks = _tokens(tcfg, (2, 128), seed=8)
    want = jax.jit(jax_forward, static_argnums=1)(jparams, jcfg,
                                                  jnp.asarray(toks)).logits
    got = forward(tparams, tcfg, t(toks)).logits
    close(got, want, **LOGIT_TOL)


def test_loss_and_every_gradient_match_reference(phi4):
    """``loss_fn`` trains through RLS-sparse attention: the loss and the
    gradient of every leaf against ``jax.value_and_grad`` (float32 masters,
    2 × 128 tokens; early query rows that see no landmark give zeros and
    finite gradients in both). At 64 tokens p_sketch is s, and this random
    model's 32nd and 33rd scores lie within the packages' 3e-5 difference
    in some heads, so the two select other landmarks there: a tie of the
    selection, not of the arithmetic."""
    jcfg, tcfg, jparams, _ = phi4
    toks = _tokens(tcfg, (2, 129), seed=9)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: jax_loss_fn(
        p, jcfg, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))))(
        jparams)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                   device="cpu", dtype=torch.float32)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, tcfg, t(toks[:, :-1]), t(toks[:, 1:]))
    grads = torch.autograd.grad(loss, leaves)
    close(loss, float(want_loss), **LOSS_TOL)
    got = tree_unflatten(list(grads), tree_flatten(params)[1])
    got = reference_tree(got)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        g = flat_g[path]
        assert np.isfinite(g).all()
        err = float(np.abs(g - np.asarray(w)).max())
        assert err <= GRAD_ATOL, f"{jax.tree_util.keystr(path)}: {err:.3g}"


# ------------------------------------------------------------- serving

def _recording(step_fn, log):
    def step(params, tokens, caches):
        logits, caches = step_fn(params, tokens, caches)
        log.append((n(tokens).copy(), n(logits)[:, -1].copy()))
        return logits, caches
    return step


def test_serve_engine_matches_jax(chatglm3):
    """chatglm3's frozen landmarks, 3 requests on 2 slots, max_len 64, 6
    new tokens: both engines feed the same tokens, their logits agree at
    every step, and the port generates the JAX engine's greedy tokens (no
    step's top-2 gap falls below the tolerance with these seeds). The JAX
    engine steps through the decode step that the frozen-decode test
    compiled (the same shapes)."""
    jcfg, tcfg, jparams, tparams = chatglm3
    prompts = [_tokens(tcfg, (k,), seed=10 + k) for k in (5, 9, 3)]
    jeng = JaxServeEngine(jcfg, jparams, slots=2, max_len=64)
    teng = ServeEngine(tcfg, tparams, slots=2, max_len=64)
    jlog, tlog = [], []
    jeng.step_fn = _recording(
        lambda p, tokens, caches: jax_step(p, jcfg, tokens, caches), jlog)
    teng.step_fn = _recording(teng.step_fn, tlog)
    for uid, p in enumerate(prompts):
        jeng.submit(JaxRequest(uid=uid, prompt=p, max_new_tokens=6))
        teng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    jdone = {r.uid: r.generated for r in jeng.run()}
    tdone = {r.uid: r.generated for r in teng.run()}
    assert len(tlog) == len(jlog) == teng.steps
    for step, ((jt, jl_), (tt, tl_)) in enumerate(zip(jlog, tlog)):
        np.testing.assert_array_equal(tt, jt, err_msg=f"step {step}")
        close(tl_, jl_, **LOGIT_TOL)
        top2 = np.sort(jl_, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > LOGIT_TOL["atol"], step
    assert tdone == jdone and sorted(tdone) == [0, 1, 2]
    assert teng.caches.lm is not None


def test_serve_cli_nystrom_runs_on_the_cpu(capsys):
    """``--nystrom`` as the reference's launcher sets it (64 landmarks, 16
    recent)."""
    done = serve_cli.main(["--arch", "phi4-mini-3.8b", "--device", "cpu",
                           "--nystrom",
                           "--requests", "2", "--slots", "2", "--max-new",
                           "2", "--max-len", "64"])
    assert len(done) == 2 and all(len(r.generated) == 2 for r in done)
    assert "served 2/2 requests" in capsys.readouterr().out
