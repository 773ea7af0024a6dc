#!/usr/bin/env python3
"""The JAX package's own bf16 gap between RLS-sparse attention at p = s and
exact attention, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/rls_identity_probe.py

At p = s every key is a landmark, so ``nystrom_attention(causal=True)`` is
exact causal attention computed in the activation dtype: bf16 logits over
a bf16-rounded √d, a bf16 softmax and a bf16 ``w·v``. ``attention_ref``
takes the logits to float32 before the softmax. The probe draws q, k and v
at (1, 4, 1,024, 128) from N(0, 1) (numpy, seed 0), runs both in bf16 in
the JAX package and prints the largest |Δ| of the outputs (in float32)
beside the largest |output|; the port's gap on the same inputs follows.
``chip_smoke.py``'s phase ``rls`` (b) holds the port's p = s output
against K4 on the card within twice the JAX package's gap
(``RLS_IDENTITY_ATOL``). A statement about arithmetic, not a timing.
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.attention_nystrom import nystrom_attention
from repro.kernels import ref
from repro_torch.core import attention_nystrom as port

SHAPE = (1, 4, 1024, 128)


def main() -> None:
    g = np.random.default_rng(0)
    q, k, v = (g.standard_normal(SHAPE).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    s = SHAPE[2]
    lm = jnp.broadcast_to(jnp.arange(s), SHAPE[:2] + (s,))
    got = np.asarray(nystrom_attention(jq, jk, jv, num_landmarks=s,
                                       landmarks=lm).out, np.float32)
    want = np.asarray(ref.attention_ref(jq, jk, jv, causal=True), np.float32)
    gap = float(np.abs(got - want).max())
    print(f"JAX bf16 at {SHAPE}: nystrom_attention(p = s) against "
          f"attention_ref: max|Δ| {gap:.6g}, max|out| "
          f"{float(np.abs(want).max()):.6g}, elements that differ "
          f"{float((got != want).mean()):.4f}")
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    mine = port.nystrom_attention(
        tq, tk, tv, num_landmarks=s,
        landmarks=torch.arange(s).expand(SHAPE[:2] + (s,))).out.float()
    print(f"port bf16, the same inputs: max|Δ| against the JAX "
          f"attention_ref {float(np.abs(mine.numpy() - want).max()):.6g}, "
          f"against the JAX nystrom_attention "
          f"{float(np.abs(mine.numpy() - got).max()):.6g}")


if __name__ == "__main__":
    main()
