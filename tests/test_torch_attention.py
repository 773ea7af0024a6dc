"""K4's plain version and the port's attention branches against the JAX
package on the CPU.

``ops.attention`` on CPU tensors is K4's plain version
(``ref.flash_attention_ref``). It is held against the JAX ``ops.attention``,
which runs the Pallas flash kernel in interpret mode as
tests/test_kernels_pallas.py runs it, on three GQA / causal / window cells
in float32 at that file's atol 2e-5 and on one bfloat16 cell; and against
the port's ``ref.attention_ref`` on the whole grid of that file (GQA ×
mask) at S ∈ {32, 96, 256, 512} and D ∈ {32, 64, 128}, which is cheap:
that ``attention_ref`` is itself held against the JAX ``ref.attention_ref``
here. The chunked online softmax (the port's ``flash_attention_chunked``)
and the softcapped branch are held against their JAX counterparts.
K4's bf16 instance on the card computes in other arithmetic than its plain
version (tensor cores, softmax weights rounded to bf16 for P·V): a plain
emulation of that arithmetic is held against the Pallas kernel at bf16
under the card's tolerance. Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import close, n, t
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attention
from repro_torch.kernels import ops, ref
from repro_torch.models import attention

F32_TOL = dict(rtol=0, atol=2e-5)     # tests/test_kernels_pallas.py
# bfloat16 outputs of the same float32 arithmetic differ by at most one
# rounding of the output: one bf16 spacing, at most 2^-7 of the value
BF16_TOL = dict(rtol=2.0 ** -7, atol=2e-5)
# rounding each softmax weight p_ij to bf16 (unit roundoff 2^-8) moves an
# output o_id by at most 2^-8·Σ_j p_ij|v_jd|/l_i more, the plain version on
# (q, k, |v|): K4's bf16 tolerance on the card (chip_smoke.py,
# tests/test_torch_cuda_attention.py)
P_ROUND = 2.0 ** -8
GQA = [(8, 8), (8, 2), (4, 1)]
MASKS = [(True, 0), (False, 0), (True, 64)]

# the float32 JAX references under jit (cheaper here than op by op)
jax_attention_ref = jax.jit(jax_ref.attention_ref,
                            static_argnames=("causal", "window"))
jax_flash_jnp = jax.jit(jax_attention.flash_attention_jnp,
                        static_argnames=("causal", "window", "softcap",
                                         "chunk_q", "chunk_k"))
jax_softcap = jax.jit(jax_attention._softcap_attention,
                      static_argnums=(3, 4))


def _qkv(b, hq, hkv, s, d, seed, dtype=np.float32):
    g = np.random.default_rng(seed)
    return (g.standard_normal((b, hq, s, d)).astype(dtype),
            g.standard_normal((b, hkv, s, d)).astype(dtype),
            g.standard_normal((b, hkv, s, d)).astype(dtype))


@pytest.mark.parametrize("hq,hkv,causal,window",
                         [(8, 2, True, 0), (4, 1, True, 64),
                          (8, 8, False, 0)])
def test_plain_k4_matches_pallas_interpret(hq, hkv, causal, window):
    q, k, v = _qkv(1, hq, hkv, 256, 32, seed=hq + hkv)
    want = jax_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    got = ops.attention(t(q), t(k), t(v), causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    close(got, want, **F32_TOL)


# bf16 cells (hq, hkv, S, D, causal, window, seed): the first is the cell of
# test_plain_k4_matches_pallas_interpret_bf16
BF16_CELLS = {"causal": (4, 2, 128, 64, True, 0, 7),
              "gqa-window": (4, 1, 256, 32, True, 64, 13)}


@pytest.fixture(scope="module")
def pallas_bf16():
    """Each bf16 cell through the Pallas kernel in interpret mode, once:
    name -> (q, k, v as bf16 tensors, the kernel's output in float32)."""
    out = {}
    for name, (hq, hkv, s, d, causal, window, seed) in BF16_CELLS.items():
        arrays = [jnp.asarray(a, jnp.bfloat16)
                  for a in _qkv(1, hq, hkv, s, d, seed=seed)]
        want = jax_ops.attention(*arrays, causal=causal, window=window)
        out[name] = (tuple(t(np.asarray(a, np.float32)).bfloat16()
                           for a in arrays), np.asarray(want, np.float32))
    return out


def test_plain_k4_matches_pallas_interpret_bf16(pallas_bf16):
    (q, k, v), want = pallas_bf16["causal"]
    got = ops.attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    close(got.float(), want, **BF16_TOL)


def k4_tensor_core_emulation(q, k, v, *, causal=True, window=0, scale=0.0):
    """What K4's bf16 instance computes, in plain torch: q·kᵀ from the bf16
    values (each product exact in float32) summed in float32, the scale
    applied after the product, softmax weights P in float32, l summed from
    them, P rounded to bf16 for P·V (float32 sums), the output cast to bf16.
    Exact softmax over all keys; the kernel's online softmax is the same
    function up to the order of its sums."""
    B, Hq, S, D = q.shape
    g = Hq // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    logits = (q.float() @ kf.transpose(-1, -2)) * (scale or D ** -0.5)
    pos = torch.arange(S)
    logits = logits.masked_fill(~ref.attention_mask(pos, pos, causal, window),
                                float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    return ((p.bfloat16().float() @ vf) / l.clamp_min(1e-30)).to(q.dtype)


@pytest.mark.parametrize("cell", list(BF16_CELLS))
def test_k4_tensor_core_arithmetic_matches_pallas_interpret(pallas_bf16,
                                                            cell):
    """The redesign stays within the card's bf16 tolerance of the TPU
    kernel's function: element by element, atol 2e-5 +
    2^-8·plain(q, k, |v|), rtol 2^-7."""
    (q, k, v), want = pallas_bf16[cell]
    _, _, _, _, causal, window, _ = BF16_CELLS[cell]
    got = k4_tensor_core_emulation(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    want = torch.as_tensor(want)
    moved = ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                    causal=causal, window=window)
    tol = (BF16_TOL["atol"] + P_ROUND * moved
           + BF16_TOL["rtol"] * want.abs())
    share = float(((got.float() - want).abs() / tol).max())
    assert share <= 1, f"{share:.3f} of the tolerance"


@pytest.mark.parametrize("hq,hkv", GQA)
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_k4_matches_attention_ref(hq, hkv, causal, window):
    for s in (32, 96, 256, 512):
        for d in (32, 64, 128):
            q, k, v = (t(a) for a in _qkv(1, hq, hkv, s, d, seed=s + d))
            want = ref.attention_ref(q, k, v, causal=causal, window=window)
            got = ops.attention(q, k, v, causal=causal, window=window)
            close(got, want, **F32_TOL)


def test_port_attention_ref_matches_jax():
    """float32, and bfloat16 (logits rounded in the input dtype)."""
    q, k, v = _qkv(2, 4, 2, 96, 32, seed=8)
    for causal, window in MASKS:
        want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window)
        close(ref.attention_ref(t(q), t(k), t(v), causal=causal,
                                window=window), want, **F32_TOL)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    # eagerly: under jit XLA keeps the bf16 logits in float32
    want = jax_ref.attention_ref(*jb, scale=0.3)
    got = ref.attention_ref(*(t(a).bfloat16() for a in (q, k, v)), scale=0.3)
    close(got.float(), np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("s,softcap,window,chunks",
                         [(256, 0.0, 0, (64, 128)), (256, 20.0, 48, (64, 64)),
                          (2048, 0.0, 0, (512, 1024))])
def test_chunked_attention_matches_flash_attention_jnp(s, softcap, window,
                                                       chunks):
    """The forward of the reference's flash_attention_jnp; the last case
    is the attention_block branch past 1,024 tokens, at its chunk sizes."""
    q, k, v = _qkv(1, 4, 2, s, 16, seed=s)
    cq, ck = chunks
    want = jax_flash_jnp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, softcap=softcap, chunk_q=cq, chunk_k=ck)
    got = attention.flash_attention_chunked(
        t(q), t(k), t(v), causal=True, window=window, softcap=softcap,
        chunk_q=cq, chunk_k=ck)
    close(got, want, **F32_TOL)


def test_softcap_attention_matches_jax():
    q, k, v = _qkv(2, 4, 2, 64, 32, seed=9)
    for window in (0, 16):
        want = jax_softcap(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           50.0, window)
        got = attention._softcap_attention(t(q), t(k), t(v), 50.0, window)
        close(got, want, **F32_TOL)


def test_shape_contract_holds_on_the_cpu_route():
    """The Pallas wrapper's contract: S > 256 must be a multiple of 256;
    the query heads a multiple of the KV heads. No kernel launches."""
    ops.reset_launch_counts()
    q, k, v = _qkv(1, 2, 1, 300, 32, seed=10)
    with pytest.raises(ValueError, match="S=300"):
        ops.attention(t(q), t(k), t(v))
    q, k, v = _qkv(1, 3, 2, 64, 32, seed=11)
    with pytest.raises(ValueError, match="multiple"):
        ops.attention(t(q), t(k), t(v))
    q, k, v = _qkv(1, 2, 1, 96, 32, seed=12)
    assert n(ops.attention(t(q), t(k), t(v))).shape == (1, 2, 96, 32)
    assert ops.launch_counts()["flash_attention"] == 0
