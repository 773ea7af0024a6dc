"""Serving the moe, ssm and hybrid families with the port's ``ServeEngine``
against the JAX package's, on the CPU; the launchers' reductions.

The small configs and weights of ``tests/_torch_families.py`` (the JAX
smoke tests' reduction, float32). The JAX side runs one jitted serve step
per architecture and slot count (``jax_step``), which its engine and the
decode-step comparisons share, so each compiles once.

Tolerance: ``LOGIT_TOL`` = 1e-4, the dense family's; the largest
difference measured on these logits is 1.1e-5 (zamba2's decode steps).

Two faults of the reference's engine (ROADMAP §3): R3, a slot that a new
request reuses keeps its predecessor's SSM state (conv window and
recurrent state), which the reference does not reset, so its second
request of one prompt generates other tokens; the port zeroes that state
at admission. R4, the engine feeds token ids, which the vision and audio
configs cannot take (their inputs are embeddings); the port's engine
refuses them, and ``decode_step(embeds=)`` serves them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import close, n, t
from _torch_families import model
from repro.launch.train import build_small_cfg as jax_small_cfg
from repro.models import init_decode_state as jax_decode_state
from repro.runtime import Request as JaxRequest
from repro.runtime import ServeEngine as JaxServeEngine
from repro.runtime import make_serve_step as jax_make_serve_step
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.train import build_small_cfg
from repro_torch.models import decode_step, init_decode_state
from repro_torch.runtime import Request, ServeEngine, greedy_sample
from repro_torch.runtime.serve_loop import make_serve_step

LOGIT_TOL = dict(rtol=0, atol=1e-4)
MAX_LEN = 64
SLOTS = {"deepseek-moe-16b": 2, "zamba2-7b": 2, "mamba2-780m": 1}


@functools.cache
def jax_step(name: str):
    """The JAX engine's jitted serve step of one architecture."""
    jcfg = model(name)[0]
    return jax.jit(jax_make_serve_step(jcfg))


def _tokens(cfg, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _recording(step_fn, log):
    def step(params, tokens, caches):
        logits, caches = step_fn(params, tokens, caches)
        log.append((n(tokens).copy(), n(logits)[:, -1].copy()))
        return logits, caches
    return step


def _engines(name: str, slots: int):
    """The JAX and the port's engines over the same weights, each step's
    fed tokens and logits recorded."""
    jcfg, tcfg, jparams, tparams = model(name)
    jeng = JaxServeEngine(jcfg, jparams, slots=slots, max_len=MAX_LEN)
    teng = ServeEngine(tcfg, tparams, slots=slots, max_len=MAX_LEN)
    jlog, tlog = [], []
    jeng.step_fn = _recording(jax_step(name), jlog)
    teng.step_fn = _recording(teng.step_fn, tlog)
    return jeng, teng, jlog, tlog


@pytest.mark.parametrize("name", sorted(SLOTS))
def test_decode_steps_match_jax(name):
    """8 decode steps through the JAX engine's jitted step: the stacked KV
    caches (deepseek's ``layer0`` at index 0; zamba2's one per use of the
    shared block) and SSM states (zamba2: 7, mamba2: 4)."""
    jcfg, tcfg, jparams, tparams = model(name)
    b = SLOTS[name]
    toks = _tokens(tcfg, (b, 8), seed=5)
    jst = jax_decode_state(jcfg, b, MAX_LEN)
    tst = init_decode_state(tcfg, b, MAX_LEN, device="cpu")
    for i in range(8):
        jlog, jst = jax_step(name)(jparams, jnp.asarray(toks[:, i:i + 1]),
                                   jst)
        tlog, tst = decode_step(tparams, tcfg, t(toks[:, i:i + 1]), tst)
        close(tlog, jlog, **LOGIT_TOL)
    assert tst.length == 8
    if tcfg.family != "moe":
        close(tst.ssm.ssm, jst.ssm.ssm, rtol=0, atol=1e-4)
        close(tst.ssm.conv, jst.ssm.conv, rtol=0, atol=1e-4)
    assert (tst.kv is None) == (tcfg.family == "ssm")
    if tcfg.family == "hybrid":
        assert tst.kv.k.shape[0] == 2 and tst.ssm.conv.shape[0] == 7


@pytest.mark.parametrize("name,lengths", [
    ("deepseek-moe-16b", (5, 9, 3)), ("zamba2-7b", (5, 9))])
def test_serve_engine_matches_jax(name, lengths):
    """Requests on 2 slots, 4 new tokens: both engines feed the same tokens
    at every step, their logits agree, and the port generates the JAX
    engine's greedy tokens. A step where the JAX logits' top-2 gap is
    below the tolerance could pick either token, so the comparison stops
    at the first such step (none occurs with these seeds: the test asserts
    that too). deepseek's third request reuses a slot; zamba2's engine
    serves one request a slot, since a reused slot of the reference's
    keeps its predecessor's SSM state (R3). The MoE decode step runs its
    dispatch at G = 1 with a capacity of int(2·2/8·1.25 + 1) = 1 a slot:
    the reference's drop rule, kept."""
    tcfg = model(name)[1]
    jeng, teng, jlog, tlog = _engines(name, 2)
    prompts = [_tokens(tcfg, (k,), seed=10 + k) for k in lengths]
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
    assert sorted(tdone) == list(range(len(lengths)))
    assert all(len(g) == 4 for g in tdone.values())


def test_reused_slot_starts_from_a_clean_state():
    """R3: one slot, one prompt twice. The port's two requests generate the
    same tokens, and they are the JAX engine's first request's; the JAX
    engine's second request, which inherits the first one's SSM state,
    generates other tokens."""
    tcfg = model("mamba2-780m")[1]
    jeng, teng, _, _ = _engines("mamba2-780m", 1)
    prompt = _tokens(tcfg, (4,), seed=20)
    for uid in (0, 1):
        jeng.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=4))
        teng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=4))
    jdone = {r.uid: r.generated for r in jeng.run()}
    tdone = {r.uid: r.generated for r in teng.run()}
    assert tdone[0] == tdone[1] == jdone[0]
    assert jdone[1] != jdone[0]


@pytest.mark.parametrize("name", ["pixtral-12b", "musicgen-medium"])
def test_engine_refuses_the_embedding_configs(name):
    """R4: the engine's requests carry token ids."""
    _, tcfg, _, tparams = model(name)
    with pytest.raises(ValueError, match="token ids"):
        ServeEngine(tcfg, tparams, slots=2, max_len=MAX_LEN)


def test_serve_step_takes_embeddings_and_samples_codebooks():
    """The serve step passes musicgen's input as embeddings, as the
    reference's does, and the greedy sample takes one token per
    codebook."""
    _, tcfg, _, tparams = model("musicgen-medium")
    emb = t(np.random.default_rng(6).standard_normal(
        (2, 1, tcfg.d_model)).astype(np.float32))
    st = init_decode_state(tcfg, 2, 8, device="cpu")
    logits, st = make_serve_step(tcfg)(tparams, emb, st)
    want, _ = decode_step(tparams, tcfg, None,
                          init_decode_state(tcfg, 2, 8, device="cpu"),
                          embeds=emb)
    assert torch.equal(logits, want) and st.length == 1
    tok = greedy_sample(logits)
    assert tok.shape == (2, tcfg.num_codebooks)
    assert torch.equal(tok, logits[:, -1].argmax(-1))


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-780m",
                                  "zamba2-7b"])
def test_build_small_cfg_is_the_reference_reduction(name):
    """The launchers' reduced configs equal the JAX package's, field by
    field (the moe, ssm and hybrid reductions included)."""
    mine, want = build_small_cfg(name), jax_small_cfg(name)
    for f in dataclasses.fields(want):
        a, b = getattr(mine, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(b):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name


def test_serve_cli_serves_the_hybrid_family(capsys):
    """The launcher at zamba2's reduction (8 SSM layers, the shared block
    after layers 3 and 6, d_model 512) on the CPU."""
    done = serve_cli.main(["--arch", "zamba2-7b", "--device", "cpu",
                           "--requests", "2", "--slots", "2", "--max-new",
                           "2", "--max-len", "32"])
    assert len(done) == 2 and all(len(r.generated) == 2 for r in done)
    assert "served 2/2 requests" in capsys.readouterr().out
