#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA H100 and hold its kernels to account.

    python3 chip_smoke.py          # from the root of a checkout; one CUDA GPU

Drives ``repro_torch`` (never the JAX package) through eighteen phases and
exits non-zero on any failure:

  1. build     compile the CUDA kernels (``src/repro_torch/kernels/csrc``)
               with nvcc for sm_90a, one process per source, all at once;
               print the card's name and power limit.
  2. k1        K1 ``kernel_block`` against its plain PyTorch version, rbf /
               linear / poly x {f32 (SIMT), f64 (FP64 tensor cores)} at
               ragged shapes, the two mixed data/accumulation dtype builds,
               a predict batch (256, 2048, 90) and the sparse path's W =
               k(Z, Z) over 2048 densified landmark rows (d = 47,236, f32
               data, f64 accumulation).
  3. k2        K2 ``rls_scores`` against its plain version, {f32, f64} x
               p in {37, 600, 2048, 4096, 8192}, and the two mixed builds
               (float32: 3xTF32 on the tensor cores; the others SIMT fma).
  4. k3        K3 ``sparse_cross`` against its plain version, rbf / linear /
               poly x {f32, f64} and the two mixed builds at a ragged CSR
               shape (empty rows, padding slots past indptr[-1]) against
               dense N(0, 1/50) landmarks and against landmarks that are
               densified CSR rows, at (8, 8, 1), and at one full chunk of
               the sparse cell against its landmark rows; each cell logs
               its hot/other split.
  5. k4        K4 ``flash_attention`` against its plain version, float32
               (SIMT) and bfloat16 (wgmma, TMA) x (hq, hkv) in {(8,8),
               (8,2), (4,1)} x {causal, non-causal, causal + window 64} x
               S in {32, 96, 256, 512} x D in {32, 64, 128} (and D = 112,
               zamba2's, at (8,8) and (8,2)), and at the prefill shapes of
               phases lm and families, (1, 24, 8192, 128), (1, 32, 8192,
               112) and (1, 16, 8192, 128), bfloat16, causal.
  6. main      the paper's fit -> predict path at full size: MSD-shaped data
               (n = 463,715 train, 51,630 test, d = 90) from
               ``pumadyn_like(dim=90, seed=0)``, SketchConfig(RBFKernel(6.0),
               p=2048, lam=1e-6) with the defaults rls_fast / nystrom / auto,
               fit then predict_batched(batch_size=256); launch counts are
               zeroed just before and read just after.
  7. parity    the same fit at n = 20,000 through backend "hopper" and
               backend "torch" on the card, with the same draws injected.
  8. sparse    the out-of-core CSR path at the RCV1 shape (677,399 train and
               20,242 test rows, d = 47,236, about 74 values per row) from
               ``rcv1_like(seed=0)``: SketchConfig(RBFKernel(1.0), p=2048,
               lam=1e-6, chunk_rows=131,072, f32 data with f64
               accumulation and p×p solves),
               fit(X_csr, y) then predict(X_csr_test), launch counts zeroed
               before and read after; then, on the first 20,000 rows in
               chunks of 8,192 with the same draws injected, hopper against
               torch and the CSR fit against the dense fit of the same rows
               densified (K3 against K1); fit(SparseChunkSource) against
               fit(CsrMatrix), and partial_fit over three chunks + finalize.
  9. iter      the iterative solvers, the streaming backend and the
               multi-epoch end_pass protocol, launch counts zeroed before
               and read after each path: (a) solver="falkon_pcg" in memory
               on the MSD-shaped rows, fit then predict_batched(256), with
               the direct nystrom_regularized fit on the same draws beside
               it; (b) solver="eigenpro" in memory; (c) the streamed
               Theorem-4 pass alone (backend="streaming", block_rows=4096):
               its peak memory, its scores against the hopper pass and
               both against float64 scores, then a streaming fit; (d)
               falkon_pcg out of core on the RCV1-shaped rows in the
               sparse cell's configuration (K3), its beta against the
               chunked nystrom_regularized beta; (e) eigenpro through
               fit(ArrayChunkSource(MSD, chunk_rows=131,072)), counting the
               source's passes; (f) hopper (streaming) against torch at
               n = 20,000 for falkon_pcg, eigenpro and streaming. Each fit
               is profiled once more.
 10. samplers  the bless and recursive_rls samplers and the dnc solver at
               full width, launch counts zeroed before and read after each
               path, each stage timed: (a) sampler="bless" in memory on the
               MSD-shaped rows (the auto schedule at lam.eps = 5e-7; K1 with
               float64 accumulation and K2's float64-accumulating build),
               its peak memory and its test MSE beside rls_fast's; (b) bless
               out of core on the RCV1-shaped rows (K3, the sparse cell's
               configuration), counting the source's passes; (c)
               sampler="recursive_rls"; (d) solver="dnc" with 35 partitions
               of 13,249 rows, with its n^2/m kernel evaluations; (e) hopper
               against torch at n = 20,000 with the hopper fit's draws
               injected; then the in-memory score pass at the MSD cell
               against float64 scores, default policy against
               Precision(accum_dtype="f64") and the 2 x 2 of the Gram's and
               K2's precision. Each fit is profiled once more.
 11. serve     the async serve plane over two keys (the MSD rls_fast model
               and the bless model of samplers (a)): (i) four client threads
               submitting the 51,630 test rows as single-row requests,
               BatchPolicy(max_batch=256, max_wait_ms=2.0), every answer
               held to predict of its row, requests/s, p50/p99, batches by
               bucket, one K1 launch a batch, then a profiled repeat; (ii) a
               hot swap at one bucket of 256 with a deadline on every
               request while a BackgroundRefresher publishes three refreshed
               rls_fast duals (partial_fit over a chunk of 131,072 training
               rows, then finalize): every answer bit-equal to its version's
               snapshot, none dropped, no miss; then KRRServeEngine
               (batch_size=256) against predict_batched(256).
 12. bf16      the bf16 KRR paths at full width, through the bf16 instances
               of K1, K2 and K3, launch counts zeroed before and read after
               each path: first the three instances against their plain
               versions (ragged shapes and the paths' shapes; each cell's
               share of its tolerance); (a) the main path's float32 model
               served with Precision(serve_dtype="bf16"): predict_batched
               (256) (predictions/s, one bf16 K1 launch a batch, test MSE
               beside the float32 server's), AsyncServeEngine over a
               ModelSlot of it (four client threads, BatchPolicy(256,
               2.0 ms), every answer held to predict_batched) and
               KRRServeEngine(batch_size=256), and the torch backend serving
               the same state; (b) a fit from bf16 storage of the MSD rows
               (Precision(data_dtype="bf16", solve_dtype="f64"): K1 and K2
               in bf16), then predict_batched(256); (c) the RCV1 rows in
               bf16 CSR chunks of 131,072 (K3 per chunk, K1 for W); (b) and
               (c) each held hopper against torch at n = 20,000 with the
               same draws, and each fit profiled once more. It makes its
               own data and model when run alone.
 13. lm        the dense LM at phi4-mini-3.8b's published widths (32 layers,
               d_model 3072, 24 query / 8 KV heads, vocab 200,064), bfloat16,
               use_pallas, random weights from seed 0: the prefill of 1 x
               8,192 tokens (one K4 launch per layer, counts zeroed before
               and read after), its profile, its parity against the plain
               chunked attention, decode_step against the prefill at 64
               tokens, and ServeEngine(slots=4, max_len=1024) answering 8
               requests of 32 new tokens.
 14. train     LM training: (a) phi4-mini-3.8b at its published widths,
               float32 master weights from seed 0, bf16 compute,
               use_pallas, remat="full": 4 make_train_step steps of AdamW
               (lr 3e-4, warmup 2 of 8) on lm_batch at 8 x 512 tokens, K4
               launches counted each step (the forward and the recompute of
               every layer), ms a step, tokens/s, model FLOPs utilisation,
               peak memory, then one profiled step and the LM head alone;
               (b) K4 under autograd at (8, 24, 512, 128) bf16 causal: the
               forward within K4's tolerance, dq, dk, dv bit-equal to the
               plain version's autograd, forward and backward timed;
               (c) the launcher's path at build_small_cfg (float32, K4's
               SIMT instance) under TrainDriver, 12 steps with checkpoints
               every 4, uninterrupted and with a StepFailure at step 6: one
               restart, the losses equal to the uninterrupted run's.
 15. train_families
               training the moe, ssm, hybrid and audio families: K4 at the
               attention cells' training shapes, (8, 16, 512, 128),
               (8, 32, 512, 112) and (8, 24, 512, 64) bf16 causal, against
               its plain version, timed beside it and SDPA; (a) four cells
               as phase train (a) trains its model (float32 masters, bf16
               compute, use_pallas, remat="full", 4 AdamW steps at 8 x 512,
               random weights from seed 0, one model at a time):
               mamba2-780m and musicgen-medium (from embeddings, codebook
               labels) at their published size, deepseek-moe-16b cut to
               layer0 + 5 MoE layers and zamba2-7b to 7 groups of 6 (42
               layers), widths untouched; ms a step, tokens/s, MFU (N =
               the parameters one token touches), peak memory, K4 launches
               a step, one profiled step; (b) the six archs that train at
               build_small_cfg, float32: the loss and every gradient
               through K4 against the plain route (MoE routing replayed);
               (c) the launcher's TrainDriver for deepseek-moe-16b and
               musicgen-medium, 12 steps with a StepFailure at step 6: the
               losses bit-equal to the uninterrupted run's.
 16. families  the moe, hybrid, ssm and audio families at their published
               widths, bfloat16, use_pallas, random weights from seed 0,
               one model at a time, each prefill of 1 x 8,192 with the
               launch counts zeroed before and read after, timed, its peak
               memory and profile: (a) deepseek-moe-16b (K4 28 times a
               prefill), its parity against the plain chunked attention
               where each token's routing agrees in every layer, and
               ServeEngine(slots=4, max_len=1024) answering 8 requests of
               32 new tokens; (b) zamba2-7b (K4 13 times, head dim 112),
               parity, 64 decode steps against the prefill, the serve
               engine, and one prompt served twice through one slot (the
               same tokens both times); (c) mamba2-780m (no attention) and
               musicgen-medium from embeddings (K4 48 times, the codebook
               logits), each with 64 decode steps against the prefill.
 17. rls       Nyström-RLS attention (attn_approx="nystrom_rls") at
               phi4-mini-3.8b's published widths with its own 1,024
               landmarks, bf16, use_pallas, random weights from seed 0:
               (a) the prefill of 1 x 8,192 tokens through RLS-sparse
               attention (landmarks from key_rls_scores at p_sketch 2,048
               on 24 heads; no K4 launch, counts zeroed before and read
               after), timed, its peak memory, profile and share of NaN
               score rows (R9), and its logits against K4's exact prefill
               of the same weights and tokens (reported: the weights are
               random); (b) nystrom_attention at p = s against K4 on N(0, 1)
               inputs at (1, 24/8, 8,192, 128) within RLS_IDENTITY_ATOL;
               (c) ServeEngine(slots=4, max_len=8,192) answering 8 requests
               of 32 new tokens exactly and through the frozen landmarks
               (8,192 against 1,152 cache entries read a layer and step);
               (d) build_small_cfg of phi4-mini-3.8b and zamba2-7b with the
               launcher's --nystrom settings, float32: prefill and 8 decode
               steps (frozen, compressed) on the card against the same code
               on the host's CPU.
 18. summary   each kernel's time at its path's shapes (CUDA events), its
               plain version's, the matching PyTorch library call's, and
               its bound; one JSON line of kernels, then the last line
               {"ok": true, "device": {...}}.

``--phases`` runs a subset (``build,k3,sparse`` is the short call for the
sparse path, ``build,iter`` for the iterative and streaming paths (it
makes its own data; ``build,iter,summary`` adds K1's rows at their
shapes), ``build,k4,lm,summary`` for the LM, ``build,k4,train,summary``
for training, ``build,train_families,summary`` for training the other
families, ``build,k4,families,summary`` for the moe, hybrid, ssm and
audio families (K4's rows at their shapes), ``build,k2,k4,summary`` for
the kernel checks and K2 / K4 rows alone, ``build,k1,k3,summary`` for
K1's and K3's checks and rows, ``build,samplers`` and ``build,serve`` for
this slice's paths (each makes its own data and models; add ``summary`` for
their rows), ``build,bf16,summary`` for the bf16 paths and the bf16
instances' rows, ``build,rls`` for Nyström-RLS attention); the default
runs all eighteen. ``limits``, run
only when named (``build,limits``), measures K2's 3xTF32 error at p = 2048,
4096 and 8192 below the wrapper (which refuses p > 2048 in that build),
K1's float32 linear kind against ``torch.matmul`` at d = 16 and 256, and
K2's bf16 build at p = 2048, 4096 and 8192 (which the wrapper does not
limit).
Results are also written to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "k1", "k2", "k3", "k4", "main", "parity", "sparse",
          "iter", "samplers", "serve", "bf16", "lm", "train",
          "train_families", "families", "rls", "summary")
# run only when named: the measurements behind the limits that PERF.md
# states, K2's TF32X3_MAX_P (and its absence from the bf16 build) and K1's
# float32 product rate
OPT_IN = ("limits",)

# H100 SXM data sheet, the card's peak rate for each type: float32 on the
# CUDA cores (IEEE, no tensor cores), float64 on the FP64 tensor cores (the
# CUDA cores alone give half of it), TF32 and bfloat16 on the tensor cores
# (dense); HBM3 bandwidth
PEAK_OPS = {"float32": 67e12, "float64": 67e12, "tf32": 495e12,
            "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

N_TRAIN, N_TEST, DIM = 463_715, 51_630, 90
P, LAM, BANDWIDTH = 2048, 1e-6, 6.0
N_PARITY, N_PARITY_TEST = 20_000, 4096
# the RCV1 shape as LIBSVM's rcv1.binary lists it, train and test swapped as
# large-n kernel work does
RCV1_TRAIN, RCV1_TEST, RCV1_DIM = 677_399, 20_242, 47_236
CHUNK_ROWS, RCV1_BANDWIDTH = 131_072, 1.0
# float32 data and blocks, float64 accumulation and p×p solves. RBF(1.0) on
# unit-norm TF-IDF rows is e^-1 (a constant) plus small terms, so its
# Woodbury system at lam = 1e-6 is too ill-conditioned for float32: at
# n = 20,000, with the same draws, float32 throughout gives a test MSE of
# 1.31 in the port and 2.33 in the JAX package against var(f*) 1.02, where
# float64 solves give 0.783 and float64 throughout 0.786 in both
# (tools/sparse_precision_probe.py, tools/sparse_precision_reference.py);
# at the full n the float64 Cholesky of that system failed on
# float32-accumulated Gram statistics (on an H100, float64 solves alone).
# float64 accumulation makes K3 run its float32-data / float64-accumulation
# build.
SPARSE_PRECISION = dict(data_dtype="f32", accum_dtype="f64", solve_dtype="f64")
# the parity fits stream 20,000 rows in chunks of 8,192 (a padded tail
# included): chunks of CHUNK_ROWS would pad the dense rows to 24.8 GB
PARITY_CHUNK = 8192

K1_TOL = {"float32": 2e-5, "float64": 1e-12}      # atol on blocks
# K1 at a predict batch of the main path (predict_batched(256))
PREDICT_BATCH = 256
K2_RTOL = {"float32": 2e-4, "float64": 1e-12}     # elementwise rtol on scores
K2_PS = (37, 600, 2048, 4096, 8192)
# (data, accumulation) dtypes of the mixed builds, reached through acc_dtype
# when Precision.accum_dtype differs from the data dtype
MIXED = (("float32", "float64"), ("float64", "float32"))
# hopper vs torch on the card: scores by max relative error; predictions by
# max |Δ| over max |prediction|; β by ‖Δβ‖/‖β‖. One float32 rounding of
# the kernel blocks moves predictions by 3.2e-3 and β by 1.9e-3 at this
# size (the f32 Woodbury solve at nλ = 0.02 amplifies it) and scores by
# 1.2e-5 (CPU probe, float64-exact blocks rounded to float32 vs float32
# arithmetic); the tolerances leave a margin of about 6 over that.
PARITY_TOL = {"scores": 1e-4, "predictions": 2e-2, "beta": 2e-2}
# the sparse cell's parity (hopper vs torch, and the CSR fit vs the dense
# fit of the same rows densified) compares float32 blocks accumulated in
# float64 by two implementations, so they differ at most by one float32
# rounding where a float64 sum lands next to a rounding boundary. If every
# entry of the CSR rows' blocks moved by one rounding, scores would move by
# 2.1e-3 (max relative, the smallest scores), predictions by 4.2e-6 and β
# by 3.1e-6 (tools/sparse_precision_probe.py, n = 20,000, this cell's
# policy); the tolerances leave a margin of about 5 over that worst case
SPARSE_PARITY_TOL = {"scores": 1e-2, "predictions": 2e-5, "beta": 2e-5}
K3_TOL = {"float32": 2e-5, "float64": 1e-12}      # atol on blocks
# phase iter. The streamed score pass against the hopper pass on the same
# landmarks, max relative error of the scores: in float32 the two routes
# differ by more than PARITY_TOL's 1e-4. The streamed route sums CᵀC in
# float32 and reads it through L⁻¹; the dense route rounds B = C L⁻ᵀ (a
# float64 solve) to float32 and sums BᵀB. Against float64 scores on the
# same landmarks, on the CPU (tools/iter_parity_probe.py): streamed
# 1.56e-4 / 1.83e-4 / 3.09e-4 at n = 20,000 / 40,000 / 80,000 and 8.62e-4
# at the cell's 463,715; dense 1.77e-5 / 1.31e-5 / 1.26e-5. The bound at
# the full n is about 11x the CPU's 8.8e-4 for the two together; at the
# parity size (f), 13x its 1.56e-4 (there one float32 rounding of the
# blocks alone moves the streamed scores by 1.53e-4).
ITER_SCORES_TOL = 1e-2
ITER_PARITY_SCORES_TOL = 2e-3
# (f) does not hold falkon_pcg's β between hopper and torch: at this λ the
# float32 system does not determine β below a few per cent. On an H100
# (n = 20,000; tools/falkon_beta_probe.py), the two converge (108 and 113
# iterations with solver_iters = 300; 100 at the default) to β's 3.6e-2
# apart, each 2.6e-2 from the direct float32 nystrom_regularized β with
# the same draws, while their predictions agree to 6.2e-6 at the test
# rows and 2.3e-5 at the training rows: the directions they part along
# carry no prediction. Predictions are held for every path.
ITER_FREE_BETA = {("falkon_pcg", "beta")}
# the out-of-core falkon_pcg beta against the chunked nystrom_regularized
# beta (relative l2; the reference's bound between the two solvers,
# tests/test_iterative.py)
ITER_BETA_TOL = 1e-3
# phase samplers (d): 463,715 = 35 x 13,249, so every row is in a partition
DNC_PARTITIONS = 35
# phase serve (ii): the deadline of every request of the hot swap
SERVE_DEADLINE_MS = 5000.0
# phase bf16. The kernels against their plain versions, element by element:
# K1 and K3 within BF16_STEP·|plain| + the float32 check's atol (one bf16
# step beyond the float32 sum's order; K3 rounds |x|^2 and the cross
# product to bf16 before its epilogue, as its plain version does), K2 within
# rtol BF16_STEP + 2e-4, atol 1e-6. The paths' storage policy: bf16 blocks,
# float32 accumulation, float64 p×p solves (the default solve dtype is the
# data's, and bf16 has no eigh or Cholesky in either package: fault R5)
BF16_STEP = 2.0 ** -7
BF16_PRECISION = dict(data_dtype="bf16", solve_dtype="f64")
# (a): the quantized server's test MSE against the float32 server's on the
# same model, relative gap. Readings: 0.081626 against 0.081629 on an H100
# (3.7e-5), and the JAX package's 0.068438 against 0.068431 on the CPU at
# n = 20,000, p = 1,024 (1.0e-4); the bound is 5x the larger.
QUANT_MSE_GAP = 5e-4
# (a): an AsyncServeEngine answer against predict_batched, over
# Σ_j |k_j β_j|. K1 computes each block entry alike in every batch, so the
# two differ only by the float32 contraction's order at another batch
# size; phase serve reads 2.4e-8 of Σ_j |k_j β_j| for that contraction on
# an H100 (40x inside this bound).
QUANT_ANSWER_TOL = 1e-6
# the RCV1 cell in bf16 CSR chunks accumulates in float64, as the float32
# sparse cell does (SPARSE_PRECISION): with the bf16 rule's float32
# accumulation, the float64 Cholesky of its Woodbury system failed at the
# full n on an H100, through hopper and through torch alike
# (tools/bf16_sparse_full_probe.py: not positive definite at order 73 and
# 60 with each backend's own draws, at order 1727 and 1768 with the same
# draws): the float32-accumulated CᵀC, read through W's factor, carries
# more rounding than nλ = 0.68 absorbs (fault R2 of the reference, in
# bf16). At the parity size the bf16 rule fits, and runs there.
BF16_SPARSE_PRECISION = dict(data_dtype="bf16", accum_dtype="f64",
                             solve_dtype="f64")
# hopper against a plain route on the card, with the same draws ((b):
# torch; (c): torch with K3's plain version for the CSR blocks, since the
# torch route there is the reference's xla function, which does not round
# |x|^2 and the cross product to bf16 before the epilogue, and parts from
# hopper's by 1.1e-1 in the predictions at the parity size, on the CPU,
# in both accumulations): both round float32 sums taken in other orders to
# bf16, so some block entries may land on neighbouring bf16 values (on an
# H100, hopper and this route read bit-equal in both accumulations). What
# that does at the parity size, on the CPU
# (tools/bf16_parity_probe.py, n = 20,000: float32 sums against float64
# sums, each rounded to bf16 once; max relative error of the scores, ‖Δβ‖ /
# ‖β‖, max |Δy| / max |y|): (b) scores 7.7e-3 (one bf16 step of a score
# whose rounding flipped), β 4.1e-4, predictions 2.8e-4; (c) under the
# bf16 rule, scores 7.8e-3, β 9.1e-3, predictions 2.0e-2 to 2.3e-2 over
# two runs whose float32 sums took other orders (RBF(1.0) on unit-norm
# rows at λ = 1e-6 is the ill-conditioned system of fault R2).
# (c) in float64 accumulation rounds float64 sums to bf16, where two orders
# almost never part. The tolerances: two bf16 steps on scores; half a step
# on β and predictions (9x and 14x over (b)'s probe); under the bf16 rule,
# four steps (3.1e-2) on β and the reference suite's own bf16 bar, 5e-2, on
# predictions (2.1x over the probe).
BF16_PARITY_TOL = {
    "b": {"scores": 2 * BF16_STEP, "beta": BF16_STEP / 2,
          "predictions": BF16_STEP / 2},
    "c": {"scores": 2 * BF16_STEP, "beta": BF16_STEP / 2,
          "predictions": BF16_STEP / 2},
    "c_f32acc": {"scores": 2 * BF16_STEP, "beta": 4 * BF16_STEP,
                 "predictions": 5e-2},
}

# K4 against its plain version: float32 at the atol of
# tests/test_kernels_pallas.py (both IEEE float32). bfloat16, compared in
# float32: the kernel takes q.k from bf16 products summed in float32 (exact
# products, so only the order of the sums differs) and rounds each softmax
# weight p_ij to bf16 for P.V, while l_i sums the unrounded weights. A
# rounded weight moves by at most 2^-8 of itself (bf16's unit roundoff), so
# an output o_id = sum_j p_ij v_jd / l_i moves by at most
# 2^-8 sum_j p_ij |v_jd| / l_i: the plain version on (q, k, |v|), in
# float32. Both sides then round the output to bf16 once, one bf16 spacing
# (at most 2^-7 of the value) apart. Tolerance, element by element: atol
# 2e-5 + 2^-8 plain(q, k, |v|), rtol 2^-7
K4_ATOL, K4_BF16_RTOL, K4_BF16_P_ROUND = 2e-5, 2.0 ** -7, 2.0 ** -8
K4_GQA = ((8, 8), (8, 2), (4, 1))
# zamba2-7b's head dim (3584 over 32 heads), swept at these (hq, hkv)
K4_D112, K4_D112_GQA = (112,), ((8, 8), (8, 2))
K4_MASKS = ((True, 0), (False, 0), (True, 64))
# the LM cell: phi4-mini-3.8b at its published widths, one prefill of
# LM_SEQ tokens, and the serve engine's load
LM_ARCH, LM_SEQ, LM_DECODE_PROMPT = "phi4-mini-3.8b", 8192, 64
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW = 4, 1024, 8, 32
# prefill through K4 against prefill through the plain chunked attention,
# and decode against prefill: both sides compute attention in float32 and
# round its output to bfloat16; the float32 sums differ in order (~1e-7
# relative), which flips some of those roundings by one bf16 spacing, and
# the flips travel through 32 bf16 layers into bf16 logits. On the CPU a
# cut of this config (8 layers, d_model 768, S = 1,280;
# tools/lm_bf16_parity_probe.py) moved the logits by at most 0.0625 (one
# bf16 spacing of a logit of 8 to 16) against a largest logit of 17.4, with
# every arg-max equal. The tolerance: max |Δ| within
# 2^-4 of the largest |logit| (8 spacings of it), and the arg-max equal at
# 99 % of the positions or more (a position whose top two logits lie closer
# than the rounding can flip)
LM_LOGIT_RTOL, LM_ARGMAX_AGREE = 2.0 ** -4, 0.99
# phase families: the moe, hybrid, ssm and audio cells at their published
# widths
MOE_ARCH, ZAMBA_ARCH = "deepseek-moe-16b", "zamba2-7b"
MAMBA_ARCH, AUDIO_ARCH = "mamba2-780m", "musicgen-medium"
# decode against prefill of the SSM cells, max |Δ| over the largest logit:
# the prefill's chunked SSD (its Gram, decay and diagonal term in bf16)
# and the decode steps' float32 recurrence round at different places, and
# the difference grows with depth. The JAX package does the same at these
# widths (on the CPU, tools/ssm_decode_parity_probe.py: zamba2 cut to
# 6 / 12 / 24 layers 0.0176 / 0.0307 / 0.0436, mamba2 cut to 12 / 24
# 0.0379 / 0.0455, the port 0.0159 / 0.0302 / 0.0367 and 0.0303 / 0.0506);
# it grows more slowly than the depth. The bound: the reference's at 24
# layers, grown linearly to the cell's depth (0.147 and 0.091); the other
# cells keep LM_LOGIT_RTOL
SSM_DECODE_RTOL = {ZAMBA_ARCH: 0.0436 * 81 / 24, MAMBA_ARCH: 0.0455 * 48 / 24}
# phase rls: the LM cell's model with attn_approx="nystrom_rls" at its own
# nystrom_landmarks (1,024 of the 8,192 prefill tokens, p_sketch 2,048),
# served over caches of RLS_MAX_LEN (frozen landmarks: 1,024 strided
# positions and the 128 recent ones read a step, against 8,192)
RLS_MAX_LEN = 8192
# (b): nystrom_attention at p = s (every key a landmark: exact causal
# attention in bf16 arithmetic) against K4 on the same N(0, 1) inputs at
# the prefill shape. The JAX package's own gap between the two exact
# routes, nystrom_attention at p = s against attention_ref, in bf16 at
# (1, 4, 1,024, 128) on the CPU: max |Δ| 0.015625 (one bf16 spacing of an
# output in [2, 4); tools/rls_identity_probe.py). The bound is twice it
RLS_IDENTITY_GAP = 0.015625
RLS_IDENTITY_ATOL = 2 * RLS_IDENTITY_GAP
# (d): the launcher's reduction (launch/serve.py --nystrom: 64 landmarks,
# 16 recent) of phi4-mini-3.8b and zamba2-7b, float32, a prefill of
# RLS_SMALL_SEQ tokens and RLS_SMALL_STEPS decode steps over caches of
# RLS_SMALL_SEQ, on the card and on the host's CPU; logits held to
# tests/test_torch_lm.py's LOGIT_TOL
RLS_SMALL = dict(attn_approx="nystrom_rls", nystrom_landmarks=64,
                 rls_keep_recent=16)
RLS_SMALL_SEQ, RLS_SMALL_STEPS, RLS_CPU_LOGIT_ATOL = 256, 8, 1e-4
# phase train (a): the LM cell's model trained at the launcher's batch and
# length, float32 masters, bf16 compute, every layer rematerialised
# (remat="dots" would keep about 7.2 GB more of matrix products), AdamW at
# lr 3e-4 warming up over 2 of 8 scheduled steps; running out of memory
# fails the phase
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 4
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=8)
# (c): the launcher's path at build_small_cfg under TrainDriver, a
# checkpoint every 4 steps, one injected failure
TRAIN_DRIVER_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 12, 4, 6
# (c) holds the restarted run's losses to the clean run's bit for bit when
# the step is deterministic; else (an op whose sums land in another order
# from run to run) within this relative difference
TRAIN_LOSS_RTOL = 1e-6
# phase train_families: the moe, ssm, hybrid and audio cells trained as
# phase train (a) trains the dense cell (float32 masters, bf16 compute,
# remat="full", AdamW at TRAIN_OPT, TRAIN_STEPS steps at TRAIN_BATCH x
# TRAIN_SEQ), one model at a time. Masters, m, v and the gradients take 16
# bytes a parameter: mamba2-780m (12.50 GB) and musicgen-medium (29.30 GB,
# the codebook head included) train at their published size;
# deepseek-moe-16b (262 GB) is cut to layer0 and 5 MoE layers (embed and
# unembed 6.7 GB, layer0 1.35, an MoE layer 9.41: 55.08 GB) and zamba2-7b
# (106.8 GB) to 7 whole groups of 6 SSM layers, each with its shared block
# (the two tables 3.76 GB, the shared block 3.29, an SSM layer 1.21: 57.87
# GB); widths untouched
TRAIN_FAMILIES = ((MAMBA_ARCH, {}), (AUDIO_ARCH, {}),
                  (MOE_ARCH, dict(n_layers=6)), (ZAMBA_ARCH, dict(n_layers=42)))
# (b): the six archs at the launcher's build_small_cfg, float32, the same
# weights and batch through K4's SIMT instance and through the plain
# chunked attention (the MoE routing of the plain run replayed in the K4
# run, since a rounding can flip a top-k choice): the loss within rtol
# TRAIN_ROUTE_LOSS_RTOL, each gradient leaf within TRAIN_ROUTE_GRAD_RTOL of
# the plain one in relative l2 norm (a leaf that the loss does not reach is
# zero on both). Both routes are IEEE float32 and differ only in the
# attention forward's order of summation (at most 2e-5 absolute, phase
# k4), which the backward carries through the same plain autograd. On an
# H100 the losses came out equal and the worst leaf 1.5e-5 of its norm
# (zamba2-7b's A_log; the attention archs' wk 2.4e-6 to 4.6e-6): margins
# of 6.6 and more
TRAIN_ROUTE_LOSS_RTOL, TRAIN_ROUTE_GRAD_RTOL = 1e-5, 1e-4
TRAIN_SMALL_ARCHS = (MOE_ARCH, "llama4-scout-17b-a16e", MAMBA_ARCH,
                     ZAMBA_ARCH, "pixtral-12b", AUDIO_ARCH)
# (c): the launcher's driver at build_small_cfg with one injected failure,
# for the MoE arch (its dispatch takes no atomics, forward or backward:
# bit-equal) and the codebook arch (embeddings from batch_for_step)
TRAIN_DRIVER_ARCHS = (MOE_ARCH, AUDIO_ARCH)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ------------------------------------------------------------------ phases

def phase_build(res: dict) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build()
    res["build_s"] = time.perf_counter() - t0
    log(f"[build] {', '.join(p.name for p in libs.values())} in "
        f"{res['build_s']:.1f} s")
    res["ptxas"] = {}
    for path in libs.values():
        name = path.stem.split("-")[0]
        logfile = path.with_suffix(".log")
        if logfile.exists():
            res["ptxas"][name] = _ptxas_lines(logfile.read_text())
            for line in res["ptxas"][name]:
                log(f"[build] {name}: {line}")
        sass = _sass_counts(path)
        if sass:
            log(f"[build] {name}: SASS tensor-core instructions {sass}")
            res.setdefault("sass", {})[name] = sass
    res["card"] = card_line()
    log(f"[build] card (nvidia-smi name, power.limit): {res['card']}")


def _ptxas_lines(text: str) -> list[str]:
    """Each kernel's entry name (mangled, less its anonymous-namespace
    prefix) with its registers, shared memory and spills, from ``ptxas -v``
    output."""
    import re
    out, fn = [], "?"
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "",
                        line.split("'")[1])[:60]
        elif "registers" in line or "spill" in line:
            out.append(f"{fn}: {line.replace('ptxas info    :', '').strip()}")
    return out


def _sass_counts(lib: Path) -> dict:
    """How many wgmma (HGMMA) and mma.sync (HMMA) instructions the
    library's SASS holds, from ``cuobjdump -sass``; empty where the tool
    is missing."""
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).with_name("cuobjdump"))
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    return {op: sum(1 for ln in sass.splitlines() if f" {op}." in ln)
            for op in ("HGMMA", "HMMA")}


def phase_k1(res: dict, keep: dict) -> None:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rbf_block import kernel_block
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = {}
    for n, p, d in [(1031, 257, 90), (8, 8, 1), (4096, 2048, 90)]:
        for dtype in (torch.float32, torch.float64):
            # inputs ~ N(0, 1/d): every kind's values are O(1), so one
            # absolute tolerance per dtype is meaningful
            X = torch.randn(n, d, generator=g, device="cuda",
                            dtype=dtype) / d ** 0.5
            Z = torch.randn(p, d, generator=g, device="cuda",
                            dtype=dtype) / d ** 0.5
            cases = {
                "rbf": (dict(bandwidth=1.0), ref.rbf_block_ref(X, Z, 1.0)),
                "linear": ({}, ref.linear_block_ref(X, Z)),
                "poly": (dict(degree=3, scale=1.0, offset=1.0),
                         ref.poly_block_ref(X, Z, 3, 1.0, 1.0)),
            }
            for kind, (params, want) in cases.items():
                got = kernel_block(X, Z, kind=kind, **params)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                name = str(dtype).removeprefix("torch.")
                tol = K1_TOL[name]
                log(f"[k1] {kind:6s} {name} (n,p,d)=({n},{p},{d}) "
                    f"max|Δ|={err:.3e} (atol {tol:g})")
                check(got.dtype == dtype and got.shape == (n, p),
                      f"k1 {kind} {name} returned {got.dtype} {got.shape}")
                check(err <= tol, f"k1 {kind} {name} ({n},{p},{d}): "
                      f"max|Δ| {err:.3e} > {tol:g}")
                worst[f"{kind}.{name}"] = max(worst.get(f"{kind}.{name}", 0),
                                              err)
    # the mixed builds (acc_dtype unlike the data dtype), against the plain
    # version under the same accumulation; the float32 side sets the error
    n, p, d = 1031, 257, 90
    for dt_name, acc_name in MIXED:
        dtype, acc = getattr(torch, dt_name), getattr(torch, acc_name)
        X = (torch.randn(n, d, generator=g, device="cuda", dtype=torch.float64)
             / d ** 0.5).to(dtype)
        Z = (torch.randn(p, d, generator=g, device="cuda", dtype=torch.float64)
             / d ** 0.5).to(dtype)
        Xa, Za = X.to(acc), Z.to(acc)
        cases = {
            "rbf": (dict(bandwidth=1.0), ref.rbf_block_ref(Xa, Za, 1.0)),
            "linear": ({}, ref.linear_block_ref(Xa, Za)),
            "poly": (dict(degree=3, scale=1.0, offset=1.0),
                     ref.poly_block_ref(Xa, Za, 3, 1.0, 1.0)),
        }
        name = f"{dt_name}/{acc_name}"
        for kind, (params, want) in cases.items():
            got = kernel_block(X, Z, kind=kind, acc_dtype=acc, **params)
            torch.cuda.synchronize()
            err = float((got - want.to(dtype)).abs().max())
            tol = K1_TOL["float32"]
            log(f"[k1] {kind:6s} data/acc {name} (n,p,d)=({n},{p},{d}) "
                f"max|Δ|={err:.3e} (atol {tol:g})")
            check(got.dtype == dtype and got.shape == (n, p),
                  f"k1 {kind} {name} returned {got.dtype} {got.shape}")
            check(err <= tol, f"k1 {kind} {name}: max|Δ| {err:.3e} > {tol:g}")
            worst[f"{kind}.{name}"] = err
    # a predict batch of the main path: 64 x 64 tiles fill the card
    n, p, d = PREDICT_BATCH, P, DIM
    X = torch.randn(n, d, generator=g, device="cuda") / d ** 0.5
    Z = torch.randn(p, d, generator=g, device="cuda") / d ** 0.5
    got = kernel_block(X, Z, kind="rbf", bandwidth=BANDWIDTH)
    err = float((got - ref.rbf_block_ref(X, Z, BANDWIDTH)).abs().max())
    log(f"[k1] rbf    float32 predict batch (n,p,d)=({n},{p},{d}) "
        f"max|Δ|={err:.3e} (atol {K1_TOL['float32']:g})")
    check(err <= K1_TOL["float32"], f"k1 predict batch: max|Δ| {err:.3e}")
    worst["predict_batch"] = err
    # the sparse path's W = k(Z, Z): densified landmark rows, float32 data
    # accumulated in float64 on the FP64 tensor cores, against the plain
    # version in float64
    _, Z = _full_chunk(keep)
    Z64 = Z.double()
    for kind, params, want in (
            ("rbf", dict(bandwidth=RCV1_BANDWIDTH),
             ref.rbf_block_ref(Z64, Z64, RCV1_BANDWIDTH)),
            ("linear", {}, ref.linear_block_ref(Z64, Z64))):
        got = kernel_block(Z, Z, kind=kind, acc_dtype=torch.float64,
                           **params)
        torch.cuda.synchronize()
        err = float((got - want.float()).abs().max())
        log(f"[k1] {kind:6s} data/acc float32/float64 W shape (n,p,d)="
            f"({Z.shape[0]},{Z.shape[0]},{Z.shape[1]}), landmark rows "
            f"{100 * float((Z != 0).float().mean()):.3f} % non-zero: "
            f"max|Δ|={err:.3e} (atol {K1_TOL['float32']:g})")
        check(got.dtype == torch.float32, f"k1 W returned {got.dtype}")
        check(err <= K1_TOL["float32"], f"k1 W {kind}: max|Δ| {err:.3e}")
        worst[f"W.{kind}"] = err
    del want, got, Z64
    res["k1_check_max_abs_err"] = worst
    keep["k1"] = True


def _scores_problem(n: int, p: int, dtype, g):
    import torch
    B = torch.randn(n, p, generator=g, device="cuda",
                    dtype=torch.float64) / p ** 0.5
    A = B.T @ B + n * 1e-3 * torch.eye(p, device="cuda", dtype=torch.float64)
    M = torch.cholesky_inverse(torch.linalg.cholesky(A))
    return B.to(dtype), M


def phase_k2(res: dict, keep: dict) -> None:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rls_scores import TF32X3_MAX_P, rls_scores_fused
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    # the 3xTF32 build's error grows with p (measured up to p = 8192:
    # PERF.md), so the wrapper refuses p > TF32X3_MAX_P (2048) in it; past
    # that the float32 cells check the refusal and the float32-data,
    # float64-accumulating build that it names
    for p in K2_PS:
        for dtype in (torch.float32, torch.float64):
            n = 5003
            B, M = _scores_problem(n, p, dtype, g)
            name = str(dtype).removeprefix("torch.")
            tol = K2_RTOL[name]
            if dtype == torch.float32 and p > TF32X3_MAX_P:
                try:
                    rls_scores_fused(B, M)
                except ValueError as exc:
                    check('acc_dtype="float64"' in str(exc),
                          f"k2 refusal at p={p} does not name float64: {exc}")
                else:
                    check(False, f"k2 float32 build ran at p={p} > "
                          f"{TF32X3_MAX_P}")
                got = rls_scores_fused(B, M, acc_dtype=torch.float64)
                want = ref.rls_scores_ref(B.double(), M).float()
                rel = float(((got - want).abs() / want.abs()).max())
                log(f"[k2] float32 (n,p)=({n},{p}) refused; data/acc "
                    f"float32/float64 max rel Δ={rel:.3e} (rtol {tol:g})")
                check(rel <= tol, f"k2 float32/float64 p={p}: {rel:.3e}")
                res.setdefault("k2_rel_err_by_p", {})[
                    f"float32/float64.p{p}"] = rel
                continue
            got = rls_scores_fused(B, M)
            want = ref.rls_scores_ref(B, M.to(dtype))
            torch.cuda.synchronize()
            rel = float(((got - want).abs() / want.abs()).max())
            log(f"[k2] {name} (n,p)=({n},{p}) max rel Δ={rel:.3e} "
                f"(rtol {tol:g}, {tol / max(rel, 1e-300):.1f}x inside), "
                f"scores in [{float(want.min()):.3g}, "
                f"{float(want.max()):.3g}]")
            check(got.dtype == dtype and got.shape == (n,),
                  f"k2 {name} returned {got.dtype} {got.shape}")
            check(rel <= tol, f"k2 {name} p={p}: max rel Δ {rel:.3e} > {tol:g}")
            res.setdefault("k2_rel_err_by_p", {})[f"{name}.p{p}"] = rel
            worst[name] = max(worst.get(name, 0.0), rel)
    # the mixed builds, against the plain version under the same accumulation
    n, p = 5003, 600
    for dt_name, acc_name in MIXED:
        dtype, acc = getattr(torch, dt_name), getattr(torch, acc_name)
        B, M = _scores_problem(n, p, dtype, g)
        got = rls_scores_fused(B, M, acc_dtype=acc)
        want = ref.rls_scores_ref(B.to(acc), M.to(acc)).to(dtype)
        torch.cuda.synchronize()
        name = f"{dt_name}/{acc_name}"
        rel = float(((got - want).abs() / want.abs()).max())
        tol = K2_RTOL["float32"]
        log(f"[k2] data/acc {name} (n,p)=({n},{p}) max rel Δ={rel:.3e} "
            f"(rtol {tol:g})")
        check(got.dtype == dtype and got.shape == (n,),
              f"k2 {name} returned {got.dtype} {got.shape}")
        check(rel <= tol, f"k2 {name} p={p}: max rel Δ {rel:.3e} > {tol:g}")
        worst[name] = rel
    res["k2_check_max_rel_err"] = worst
    keep["k2"] = True


def _rcv1(keep: dict) -> dict:
    """The sparse cell's rows (made once per run): train/test ``CsrMatrix``
    on the host in float32, targets and the noiseless f* of the test rows."""
    if "rcv1" in keep:
        return keep["rcv1"]
    import numpy as np
    from repro_torch.data import CsrMatrix, rcv1_like
    t0 = time.perf_counter()
    d = rcv1_like(RCV1_TRAIN + RCV1_TEST, dim=RCV1_DIM, seed=0)
    ptr, cut = d["indptr"], int(d["indptr"][RCV1_TRAIN])
    data = d["data"].astype(np.float32)
    train = CsrMatrix(data[:cut], d["indices"][:cut], ptr[:RCV1_TRAIN + 1],
                      RCV1_DIM)
    test = CsrMatrix(data[cut:], d["indices"][cut:],
                     (ptr[RCV1_TRAIN:] - cut).astype(np.int32), RCV1_DIM)
    keep["rcv1"] = dict(
        train=train, test=test, y=d["y"][:RCV1_TRAIN].astype(np.float32),
        f_test=d["f_star"][RCV1_TRAIN:].astype(np.float32),
        seconds=time.perf_counter() - t0)
    lengths = np.diff(ptr)
    log(f"[data] rcv1_like: {RCV1_TRAIN} train + {RCV1_TEST} test rows, "
        f"d={RCV1_DIM}, {cut} + {data.shape[0] - cut} stored values (rows "
        f"of {lengths.min()} to {lengths.max()}, mean {lengths.mean():.1f}), "
        f"made in {keep['rcv1']['seconds']:.1f} s")
    return keep["rcv1"]


def _csr_rows(X, lo: int, hi: int):
    """Rows [lo, hi) of a host ``CsrMatrix``, sliced through indptr."""
    from repro_torch.data import CsrMatrix
    a, b = int(X.indptr[lo]), int(X.indptr[hi])
    return CsrMatrix(X.data[a:b], X.indices[a:b], X.indptr[lo:hi + 1] - a,
                     X.n_cols)


def _full_chunk(keep: dict):
    """One full chunk of the sparse cell on the card (the first one of its
    ``SparseChunkSource``) and 2048 landmark rows of the training set."""
    if "chunk" not in keep:
        import torch
        from repro_torch.data import SparseChunkSource
        rc = _rcv1(keep)
        first = next(SparseChunkSource(rc["train"], chunk_rows=CHUNK_ROWS)
                     .chunks())
        idx = torch.randperm(RCV1_TRAIN, generator=torch.Generator()
                             .manual_seed(5))[:P]
        keep["chunk"] = first.X.cast(torch.float32, "cuda")
        keep["chunk_Z"] = rc["train"][idx].to("cuda")
    return keep["chunk"], keep["chunk_Z"]


def _ragged_csr(g, dtype):
    """1,031 rows over d = 5,000: 0 to 99 values a row (every 17th row
    empty), sorted distinct column ids, and 37 padding slots past
    indptr[-1] holding NaN — a kernel that read them would show it."""
    import numpy as np
    import torch
    from repro_torch.data import CsrMatrix
    n, d = 1031, 5000
    lengths = g.integers(0, 100, n)
    lengths[::17] = 0
    cols = [np.sort(g.choice(d, k, replace=False)) for k in lengths]
    indices = np.concatenate(cols + [np.zeros(37, np.int64)]).astype(np.int32)
    data = np.concatenate([g.standard_normal(int(lengths.sum())) / 50 ** 0.5,
                           np.full(37, np.nan)])
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return CsrMatrix(data, indices, indptr, d).cast(dtype, "cuda")


def _k3_cases(X, Z, acc, h):
    """(kind, kernel kwargs, plain block under accumulation ``acc``)."""
    from repro_torch.kernels import ref
    cases = {"rbf": dict(bandwidth=h), "linear": {},
             "poly": dict(degree=3, scale=1.0, offset=1.0)}
    return [(kind, kw, ref.sparse_kernel_block_ref(
        X.data.to(acc), X.indices, X.indptr, Z.to(acc), kind=kind, **kw))
        for kind, kw in cases.items()]


def phase_k3(res: dict, keep: dict) -> None:
    import numpy as np
    import torch
    from repro_torch.data import CsrMatrix
    from repro_torch.kernels.sparse_block import (prepare_landmarks,
                                                  sparse_cross)
    g = np.random.default_rng(3)
    worst = {}

    def run(label, X, Z, dtype, acc, h, tol):
        prep = prepare_landmarks(Z, acc)
        log(f"[k3] {label}: {_k3_split(X, prep)}")
        for kind, kw, want in _k3_cases(X, Z, acc, h):
            got = sparse_cross(X.data, X.indices, X.indptr, Z, kind=kind,
                               acc_dtype=acc, prepared=prep, **kw)
            torch.cuda.synchronize()
            err = float((got - want.to(dtype)).abs().max())
            name = str(dtype).removeprefix("torch.")
            if acc != dtype:
                name += "/" + str(acc).removeprefix("torch.")
            log(f"[k3] {kind:6s} {name} {label} max|Δ|={err:.3e} "
                f"(atol {tol:g})")
            check(got.dtype == dtype and got.shape == (X.shape[0],
                                                      Z.shape[0]),
                  f"k3 {kind} {name} {label} returned {got.dtype} "
                  f"{tuple(got.shape)}")
            check(err <= tol, f"k3 {kind} {name} {label}: max|Δ| {err:.3e} "
                  f"> {tol:g}")
            worst[f"{kind}.{name}"] = max(worst.get(f"{kind}.{name}", 0), err)

    # ragged: landmarks ~ N(0, 1/50), so |z|^2 ≈ 100; bandwidth 8 keeps the
    # rbf values O(1)
    for dtype in (torch.float32, torch.float64):
        X = _ragged_csr(g, dtype)
        Z = torch.as_tensor(g.standard_normal((257, 5000)) / 50 ** 0.5,
                            dtype=dtype, device="cuda")
        run("(rows,p,d)=(1031,257,5000) ragged", X, Z, dtype, dtype, 8.0,
            K3_TOL[str(dtype).removeprefix("torch.")])
        # the degenerate block: 8 rows, 8 landmarks, one feature
        Xs = CsrMatrix.from_dense(g.standard_normal((8, 1))).cast(dtype,
                                                                  "cuda")
        Zs = torch.as_tensor(g.standard_normal((8, 1)), dtype=dtype,
                             device="cuda")
        run("(8,8,1)", Xs, Zs, dtype, dtype, 1.0,
            K3_TOL[str(dtype).removeprefix("torch.")])
        # landmarks as the sparse path makes them: densified CSR rows
        # (about 1 % non-zero, every 17th row empty); |z|^2 ≈ 1
        Zl = _ragged_csr(g, dtype).todense()[:257].contiguous()
        run("(1031,257,5000) ragged, landmark rows", X, Zl, dtype, dtype,
            1.0, K3_TOL[str(dtype).removeprefix("torch.")])
    for dt_name, acc_name in MIXED:
        dtype, acc = getattr(torch, dt_name), getattr(torch, acc_name)
        X = _ragged_csr(g, dtype)
        Z = torch.as_tensor(g.standard_normal((257, 5000)) / 50 ** 0.5,
                            dtype=dtype, device="cuda")
        run("(1031,257,5000) ragged", X, Z, dtype, acc, 8.0,
            K3_TOL["float32"])
        Zl = _ragged_csr(g, dtype).todense()[:257].contiguous()
        run("(1031,257,5000) ragged, landmark rows", X, Zl, dtype, acc, 1.0,
            K3_TOL["float32"])
    X, Z = _full_chunk(keep)
    for acc in (torch.float32, torch.float64):
        run(f"full chunk (rows,p,d)=({X.shape[0]},{Z.shape[0]},{RCV1_DIM}), "
            f"{int(X.indptr[-1])} values, landmark rows", X, Z,
            torch.float32, acc, RCV1_BANDWIDTH, K3_TOL["float32"])
    res["k3_check_max_abs_err"] = worst


def _k3_work(X, Z) -> tuple[int, int]:
    """(Σ_c nnz_X(c)·nnz_Z(c), nnz): the multiply-adds of X·Zᵀ that meet a
    non-zero of Z, against the dense count nnz·p."""
    import torch
    nnz = int(X.indptr[-1])
    cols = torch.bincount(X.indices[:nnz].long(), minlength=Z.shape[1])
    return int((cols * (Z != 0).sum(0)).sum()), nnz


def _k3_split(X, prep) -> str:
    """K3's path for this X and prepared Z, in one line: the hot/other
    split of Z's columns and the share of the work each carries."""
    import torch
    nnz = int(X.indptr[-1])
    hot = (prep.hot_slot.long()[X.indices[:nnz].long()] >= 0)
    work, _ = _k3_work(X, prep.Z)
    p = prep.Z.shape[0]
    return (f"hot/other split: {prep.hot.shape[0]} hot columns (dense "
            f"table) hold {100 * float(hot.float().mean()):.1f} % of X's "
            f"values; {prep.ent_j.shape[0]} list entries for the other "
            f"columns; work meeting a non-zero of Z "
            f"{100 * work / max(nnz * p, 1):.2f} % of nnz·p")


def _k4_check(q, k, v, causal: bool, window: int) -> tuple[float, float]:
    """K4 against its plain version on one input: (max |Δ|, the largest
    share of its tolerance that an element uses); fails past the
    tolerance of q's dtype."""
    from repro_torch.kernels.flash_attention import flash_attention
    return _k4_held(flash_attention(q, k, v, causal=causal, window=window),
                    q, k, v, causal, window)


def _k4_held(got, q, k, v, causal: bool, window: int) -> tuple[float, float]:
    """``got`` (K4's output on q, k, v) against the plain version, as
    ``_k4_check`` holds it."""
    import torch
    from repro_torch.kernels import ref
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"k4 returned {got.dtype} {tuple(got.shape)}")
    want = want.float()
    diff = (got.float() - want).abs()
    tol = K4_ATOL
    if q.dtype == torch.bfloat16:
        moved = ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                        causal=causal, window=window)
        tol = tol + K4_BF16_P_ROUND * moved + K4_BF16_RTOL * want.abs()
    share = float((diff / tol).max())
    check(share <= 1, f"k4 {tuple(q.shape)} {q.dtype} causal={causal} "
          f"window={window}: max|Δ| {float(diff.max()):.3e}, "
          f"{share:.3f} of the tolerance")
    return float(diff.max()), share


def _k4_inputs(shape_q, hkv: int, dtype, seed: int):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, hq, s, d = shape_q
    return tuple(torch.randn((b, h, s, d), generator=g, device="cuda")
                 .to(dtype) for h in (hq, hkv, hkv))


def phase_k4(res: dict, keep: dict) -> None:
    import torch
    worst, shares = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for hq, hkv in K4_GQA:
            dims = (32, 64, 128) + (K4_D112 if (hq, hkv) in K4_D112_GQA
                                    else ())
            for causal, window in K4_MASKS:
                err = share = 0.0
                for s in (32, 96, 256, 512):
                    for d in dims:
                        q, k, v = _k4_inputs((2, hq, s, d), hkv, dtype,
                                             seed=s + d + hq)
                        e, f = _k4_check(q, k, v, causal, window)
                        err, share = max(err, e), max(share, f)
                log(f"[k4] {name} (hq,hkv)=({hq},{hkv}) causal={causal} "
                    f"window={window}, S in 32/96/256/512, D in "
                    f"{'/'.join(map(str, dims))}: max|Δ|={err:.3e}, "
                    f"{share:.3f} of the tolerance")
                worst[name] = max(worst.get(name, 0.0), err)
                shares[name] = max(shares.get(name, 0.0), share)
    # the prefill shapes of phases lm and families, bfloat16, causal
    for tag, cfg in (("prefill_shape", _lm_config()),
                     ("zamba2_prefill_shape", _family_config(ZAMBA_ARCH)),
                     ("deepseek_prefill_shape", _family_config(MOE_ARCH))):
        shape = (1, cfg.n_heads, LM_SEQ, cfg.resolved_head_dim)
        q, k, v = _k4_inputs(shape, cfg.n_kv_heads, torch.bfloat16, seed=7)
        err, share = _k4_check(q, k, v, True, 0)
        log(f"[k4] bfloat16 {cfg.name} prefill shape {shape} (hkv "
            f"{cfg.n_kv_heads}) causal: max|Δ|={err:.3e}, {share:.3f} of the "
            f"tolerance (atol {K4_ATOL:g} + {K4_BF16_P_ROUND:g}·plain(q, k, "
            f"|v|), + {K4_BF16_RTOL:g}·|want|)")
        worst[tag], shares[tag] = err, share
        del q, k, v
    res["k4_check_max_abs_err"] = worst
    res["k4_check_max_tolerance_share"] = shares
    keep["k4"] = True


def _msd_data():
    import numpy as np
    from repro_torch.data import pumadyn_like
    data = pumadyn_like(N_TRAIN + N_TEST, dim=DIM, seed=0)
    X = data["x"].astype(np.float32)
    y = data["y"].astype(np.float32)
    f = data["f_star"].astype(np.float32)
    return (X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], f[N_TRAIN:])


def _msd(keep: dict):
    """The MSD-shaped rows (made once per run): train X, y, test X, f*."""
    if "msd" not in keep:
        keep["msd"] = _msd_data()
    return keep["msd"]


def phase_main(res: dict, keep: dict) -> None:
    import torch
    from repro_torch.api import RBFKernel, SketchConfig, SketchedKRR
    from repro_torch.kernels import ops as kops
    t0 = time.perf_counter()
    Xtr, ytr, Xte, fte = _msd(keep)
    log(f"[main] data {Xtr.shape} train, {Xte.shape} test (d={DIM}) made "
        f"in {time.perf_counter() - t0:.1f} s")
    cfg = SketchConfig(RBFKernel(BANDWIDTH), p=P, lam=LAM)
    model = SketchedKRR(cfg)
    log(f"[main] {model!r}, backend -> {model.ops().name}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # what earlier phases keep
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(Xtr, ytr)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = kops.launch_counts()
    t0 = time.perf_counter()
    yhat = model.predict_batched(Xte, batch_size=256)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - held
    f = torch.as_tensor(fte, device="cuda")
    mse = float(torch.mean((yhat - f) ** 2))
    var_f = float(torch.var(f))
    state = model.state()
    log(f"[main] fit {fit_s:.2f} s (launches {fit_counts}); predict_batched "
        f"{pred_s:.2f} s = {N_TEST / pred_s:.0f} predictions/s; launches "
        f"after predict {counts}")
    log(f"[main] peak device memory {peak / 1e9:.2f} GB above the "
        f"{held / 1e9:.2f} GB earlier phases hold; test MSE vs f* "
        f"{mse:.4f} against var(f*) {var_f:.4f}; unique sketch columns "
        f"{int(torch.unique(model.sample().idx).numel())} of {P}")
    check(yhat.shape == (N_TEST,), f"predictions shape {tuple(yhat.shape)}")
    check(bool(torch.isfinite(yhat).all()), "non-finite predictions")
    check(bool(torch.isfinite(model.scores()).all()), "non-finite scores")
    check(bool(torch.isfinite(state.beta).all()), "non-finite beta")
    check(counts["kernel_block"] >= 3,
          f"kernel_block launched {counts['kernel_block']} times (< 3)")
    check(counts["rls_scores"] >= 1,
          f"rls_scores launched {counts['rls_scores']} times (< 1)")
    check(mse < var_f, f"test MSE {mse:.4f} not below var(f*) {var_f:.4f}")
    res["main"] = dict(fit_s=fit_s, predict_s=pred_s,
                       predictions_per_s=N_TEST / pred_s,
                       peak_bytes=peak, held_bytes=held, test_mse=mse,
                       var_f_star=var_f, launches=counts,
                       fit_launches=fit_counts)
    prof = _profile(lambda: (model.fit(Xtr, ytr),
                             model.predict_batched(Xte, batch_size=256)))
    # the profiler's host cost inflates its own wall clock: the busy share
    # that means something is against the unprofiled run above
    prof["busy_share_of_unprofiled_wall"] = (
        prof["busy_us"] / 1e6 / (fit_s + pred_s))
    res["main"]["profile"] = prof
    log(f"[main] profiled fit + predict_batched: device busy "
        f"{prof['busy_us'] / 1e3:.1f} ms = "
        f"{100 * prof['busy_share_of_unprofiled_wall']:.1f} % of the "
        f"unprofiled {1e3 * (fit_s + pred_s):.0f} ms (profiled wall "
        f"{prof['wall_us'] / 1e3:.0f} ms)")
    for row in prof["kernels"]:
        log(f"[main]   {row['device_us'] / 1e3:9.2f} ms  x{row['calls']:<4d} "
            f"{row['name']}")
    keep.update(Xtr=Xtr, ytr=ytr, Xte=Xte, Z=state.landmarks,
                msd_model=_serving_copy(model), msd_mse=mse)


def phase_parity(res: dict, keep: dict) -> None:
    import torch
    from repro_torch.api import RBFKernel, SketchConfig, SketchedKRR
    from repro_torch.core.leverage import draw_landmarks
    Xtr, ytr, Xte = keep["Xtr"][:N_PARITY], keep["ytr"][:N_PARITY], \
        keep["Xte"][:N_PARITY_TEST]
    cfg = SketchConfig(RBFKernel(BANDWIDTH), p=P, lam=LAM)
    idx = draw_landmarks(torch.Generator().manual_seed(3),
                         torch.full((N_PARITY,), 1.0 / N_PARITY), P)
    hop = SketchedKRR(cfg.replace(backend="hopper")).fit(
        Xtr, ytr, score_landmarks=idx)
    plain = SketchedKRR(cfg.replace(backend="torch")).fit(
        Xtr, ytr, score_landmarks=idx, sample=hop.sample())
    s_h, s_t = hop.scores(), plain.scores()
    b_h, b_t = hop.state().beta, plain.state().beta
    y_h, y_t = hop.predict(Xte), plain.predict(Xte)
    torch.cuda.synchronize()
    errs = {
        "scores": float(((s_h - s_t).abs() / s_t.abs()).max()),
        "predictions": float((y_h - y_t).abs().max() / y_t.abs().max()),
        "beta": float(torch.linalg.norm(b_h - b_t) / torch.linalg.norm(b_t)),
    }
    for key, err in errs.items():
        log(f"[parity] hopper vs torch at n={N_PARITY}: {key} {err:.3e} "
            f"(tolerance {PARITY_TOL[key]:g})")
    for key, err in errs.items():
        check(err <= PARITY_TOL[key], f"parity {key}: {err:.3e} > "
              f"{PARITY_TOL[key]:g}")
    res["parity"] = errs


def phase_sparse(res: dict, keep: dict) -> None:
    import numpy as np
    import torch
    from repro_torch.api import (Precision, RBFKernel, SketchConfig,
                                 SketchedKRR)
    from repro_torch.core.leverage import draw_landmarks
    from repro_torch.data import SparseChunkSource
    from repro_torch.kernels import ops as kops
    rc = _rcv1(keep)
    cfg = SketchConfig(RBFKernel(RCV1_BANDWIDTH), p=P, lam=LAM,
                       chunk_rows=CHUNK_ROWS,
                       precision=Precision(**SPARSE_PRECISION))
    model = SketchedKRR(cfg)
    log(f"[sparse] {model!r}, chunk_rows={CHUNK_ROWS}, backend -> "
        f"{model.ops().name}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # what earlier phases keep
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(rc["train"], rc["y"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = kops.launch_counts()
    t0 = time.perf_counter()
    yhat = model.predict(rc["test"])
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - held
    f = torch.as_tensor(rc["f_test"], device="cuda")
    mse = float(torch.mean((yhat - f) ** 2))
    var_f = float(torch.var(f))
    log(f"[sparse] fit {fit_s:.2f} s (launches {fit_counts}); predict "
        f"{pred_s:.3f} s = {RCV1_TEST / pred_s:.0f} predictions/s; launches "
        f"after predict {counts}")
    log(f"[sparse] peak device memory {peak / 1e9:.2f} GB above the "
        f"{held / 1e9:.2f} GB earlier phases hold; test MSE vs f* "
        f"{mse:.4f} against var(f*) {var_f:.4f}; unique sketch columns "
        f"{int(torch.unique(model.sample().idx).numel())} of {P}")
    check(yhat.shape == (RCV1_TEST,), f"predictions shape {tuple(yhat.shape)}")
    check(bool(torch.isfinite(yhat).all()), "non-finite predictions")
    check(bool(torch.isfinite(model.scores()).all()), "non-finite scores")
    check(bool(torch.isfinite(model.state().beta).all()), "non-finite beta")
    check(counts["sparse_cross"] >= 19,
          f"sparse_cross launched {counts['sparse_cross']} times (< 19)")
    check(counts["rls_scores"] == 0,
          f"rls_scores launched {counts['rls_scores']} times on the sparse "
          "path (expected 0)")
    check(counts["kernel_block"] >= 2,
          f"kernel_block launched {counts['kernel_block']} times (< 2)")
    check(mse < var_f, f"test MSE {mse:.4f} not below var(f*) {var_f:.4f}")
    res["sparse"] = dict(fit_s=fit_s, predict_s=pred_s,
                         predictions_per_s=RCV1_TEST / pred_s,
                         peak_bytes=peak, held_bytes=held, test_mse=mse,
                         var_f_star=var_f, launches=counts,
                         fit_launches=fit_counts, data_s=rc["seconds"])
    prof = _profile(lambda: (model.fit(rc["train"], rc["y"]),
                             model.predict(rc["test"])))
    prof["busy_share_of_unprofiled_wall"] = (
        prof["busy_us"] / 1e6 / (fit_s + pred_s))
    res["sparse"]["profile"] = prof
    log(f"[sparse] profiled fit + predict: device busy "
        f"{prof['busy_us'] / 1e3:.1f} ms = "
        f"{100 * prof['busy_share_of_unprofiled_wall']:.1f} % of the "
        f"unprofiled {1e3 * (fit_s + pred_s):.0f} ms (profiled wall "
        f"{prof['wall_us'] / 1e3:.0f} ms)")
    for row in prof["kernels"]:
        log(f"[sparse]   {row['device_us'] / 1e3:9.2f} ms  "
            f"x{row['calls']:<4d} {row['name']}")
    keep["sparse_Z"] = model.state().landmarks

    # parity on the first N_PARITY rows, the same draws injected: the card's
    # hopper against its torch, and the CSR fit against the dense fit of the
    # same rows densified (K3 blocks against K1 blocks, same driver)
    sub, y_sub = _csr_rows(rc["train"], 0, N_PARITY), rc["y"][:N_PARITY]
    test = _csr_rows(rc["test"], 0, N_PARITY_TEST)
    idx = draw_landmarks(torch.Generator().manual_seed(3),
                         torch.full((N_PARITY,), 1.0 / N_PARITY), P)
    cfg = cfg.replace(chunk_rows=PARITY_CHUNK)
    hop = SketchedKRR(cfg.replace(backend="hopper")).fit(
        sub, y_sub, score_landmarks=idx)
    draws = dict(score_landmarks=idx, sample=hop.sample())
    # the launch counts show which blocks each fit took: the plain sparse
    # contraction (no kernel), K3, or K1 on the densified rows
    kops.reset_launch_counts()
    plain = SketchedKRR(cfg.replace(backend="torch")).fit(sub, y_sub, **draws)
    check(sum(kops.launch_counts().values()) == 0,
          f"the torch backend launched {kops.launch_counts()}")
    dense_rows = sub.todense().numpy()
    dense = SketchedKRR(cfg.replace(backend="hopper")).fit(
        dense_rows, y_sub, **draws)
    dense_counts = kops.launch_counts()
    check(dense_counts["sparse_cross"] == 0
          and dense_counts["kernel_block"] > 0,
          f"the dense fit launched {dense_counts}")
    dense_test = test.todense().to("cuda")
    del dense_rows
    y_h = hop.predict(test)
    outs = {"torch": (plain.scores(), plain.state().beta,
                      plain.predict(test)),
            "dense": (dense.scores(), dense.state().beta,
                      dense.predict(dense_test))}
    torch.cuda.synchronize()
    errs = {}
    for other, (s_o, b_o, y_o) in outs.items():
        errs[other] = {
            "scores": float(((hop.scores() - s_o).abs() / s_o.abs()).max()),
            "predictions": float((y_h - y_o).abs().max() / y_o.abs().max()),
            "beta": float(torch.linalg.norm(hop.state().beta - b_o)
                          / torch.linalg.norm(b_o)),
        }
        for key, err in errs[other].items():
            log(f"[sparse] parity CSR hopper vs {other} at n={N_PARITY}: "
                f"{key} {err:.3e} (tolerance {SPARSE_PARITY_TOL[key]:g})")
    for other, e in errs.items():
        for key, err in e.items():
            check(err <= SPARSE_PARITY_TOL[key], f"sparse parity vs {other} "
                  f"{key}: {err:.3e} > {SPARSE_PARITY_TOL[key]:g}")
    res["sparse"]["parity"] = errs

    # the other two entry points on the card: fit(source) is the CSR fit
    # bit for bit at equal chunk_rows; partial_fit over three chunks, then
    # finalize, predicts through K3 and learns
    src = SparseChunkSource(sub, y_sub, chunk_rows=PARITY_CHUNK)
    via_source = SketchedKRR(cfg.replace(backend="hopper")).fit(src, **draws)
    check(torch.equal(via_source.state().beta, hop.state().beta),
          "fit(SparseChunkSource) differs from fit(CsrMatrix)")
    kops.reset_launch_counts()
    pf = SketchedKRR(cfg)
    for lo in range(0, N_PARITY, PARITY_CHUNK):
        hi = min(lo + PARITY_CHUNK, N_PARITY)
        pf.partial_fit(_csr_rows(sub, lo, hi), y_sub[lo:hi])
    y_pf = pf.finalize().predict(test)
    torch.cuda.synchronize()
    pf_counts = kops.launch_counts()
    f_sub = torch.as_tensor(rc["f_test"][:N_PARITY_TEST], device="cuda")
    mse_pf = float(torch.mean((y_pf - f_sub) ** 2))
    log(f"[sparse] fit(SparseChunkSource) = fit(CsrMatrix) bit for bit; "
        f"partial_fit x3 + finalize at n={N_PARITY}: test MSE vs f* "
        f"{mse_pf:.4f} against var(f*) {float(torch.var(f_sub)):.4f}, "
        f"launches {pf_counts}")
    check(bool(torch.isfinite(y_pf).all()), "partial_fit: non-finite")
    check(pf_counts["sparse_cross"] >= 4,
          f"partial_fit launched sparse_cross {pf_counts['sparse_cross']} "
          "times (< 4)")
    check(mse_pf < float(torch.var(f_sub)), f"partial_fit test MSE {mse_pf}")
    res["sparse"]["partial_fit_mse"] = mse_pf


def _counting_source(X, y, chunk_rows: int):
    """An ``ArrayChunkSource`` that counts its ``chunks()`` calls (passes)."""
    from repro_torch.data import ArrayChunkSource

    class Counting(ArrayChunkSource):
        passes = 0

        def chunks(self):
            self.passes += 1
            return super().chunks()

    return Counting(X, y, chunk_rows)


def _run_path(label: str, fit, predict=None) -> dict:
    """One path of phase ``iter``: launch counts zeroed before the fit and
    read after it and after the predictions; host clock ending in a
    synchronise."""
    import torch
    from repro_torch.kernels import ops as kops
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = kops.launch_counts()
    yhat, pred_s = None, 0.0
    if predict is not None:
        t0 = time.perf_counter()
        yhat = predict(out)
        torch.cuda.synchronize()
        pred_s = time.perf_counter() - t0
    return dict(label=label, out=out, fit_s=fit_s, predict_s=pred_s,
                fit_launches=fit_counts, launches=kops.launch_counts(),
                yhat=yhat)


def _mse(yhat, f) -> float:
    import torch
    return float(torch.mean((yhat - torch.as_tensor(f, device="cuda")) ** 2))


def _profile_line(tag: str, prof: dict, wall_s: float,
                  phase: str = "iter") -> None:
    prof["busy_share_of_unprofiled_wall"] = prof["busy_us"] / 1e6 / wall_s
    top = "; ".join(f"{r['name'][:40]} {r['device_us'] / 1e3:.1f} ms "
                    f"x{r['calls']}" for r in prof["kernels"][:4])
    log(f"[{phase}] {tag} profiled: device busy {prof['busy_us'] / 1e3:.1f} ms "
        f"= {100 * prof['busy_share_of_unprofiled_wall']:.1f} % of the "
        f"unprofiled {1e3 * wall_s:.0f} ms (profiled wall "
        f"{prof['wall_us'] / 1e3:.0f} ms); top: {top}")


def phase_iter(res: dict, keep: dict) -> None:
    """The iterative solvers, the streaming backend and the multi-epoch
    end_pass protocol at full size: (a) falkon_pcg and (b) eigenpro in
    memory on the MSD-shaped rows, (c) the streamed Theorem-4 pass and a
    streaming fit, (d) falkon_pcg out of core on the RCV1-shaped rows
    (K3), (e) eigenpro through fit(ArrayChunkSource), (f) hopper against
    torch at n = 20,000 for the three."""
    import math
    import torch
    from repro_torch.api import (Precision, RBFKernel, SketchConfig,
                                 SketchedKRR)
    from repro_torch.core.backends import ops_for
    from repro_torch.core.eigenpro import auto_batch_rows
    from repro_torch.core.leverage import draw_landmarks, fast_ridge_leverage
    Xtr, ytr, Xte, fte = _msd(keep)
    out: dict = {}
    res["iter"] = out
    var_f = float(torch.var(torch.as_tensor(fte)))
    cfg = SketchConfig(RBFKernel(BANDWIDTH), p=P, lam=LAM)

    def check_fit(tag, run, n_test):
        yhat = run["yhat"]
        mse = _mse(yhat, fte if tag != "d" else _rcv1(keep)["f_test"])
        check(yhat.shape == (n_test,), f"({tag}) predictions shape")
        check(bool(torch.isfinite(yhat).all()), f"({tag}) non-finite "
              "predictions")
        check(bool(torch.isfinite(run["out"].state().beta).all()),
              f"({tag}) non-finite beta")
        return mse

    # (a) falkon_pcg in memory, then the direct fit with the same draws
    a = _run_path("a", lambda: SketchedKRR(cfg.replace(
        solver="falkon_pcg")).fit(Xtr, ytr),
        lambda m: m.predict_batched(Xte, batch_size=PREDICT_BATCH))
    st = a["out"].state()
    mse_a = check_fit("a", a, N_TEST)
    direct = SketchedKRR(cfg.replace(solver="nystrom_regularized")).fit(
        Xtr, ytr, sample=a["out"].sample())
    mse_direct = _mse(direct.predict_batched(Xte, batch_size=PREDICT_BATCH),
                      fte)
    k1_a = a["fit_launches"]["kernel_block"]
    log(f"[iter] (a) falkon_pcg in memory: fit {a['fit_s']:.2f} s, "
        f"{st.iters} iterations (solver_iters {cfg.solver_iters}, tol "
        f"{cfg.solver_tol:g}), last residuals "
        f"{[float(r) for r in st.residuals[-5:]]}; K1 launches in the fit "
        f"{k1_a} (expected iterations + 3 = {st.iters + 3}), after predict "
        f"{a['launches']['kernel_block']}; test MSE {mse_a:.4f}, direct "
        f"nystrom_regularized with the same draws {mse_direct:.4f} (ratio "
        f"{mse_a / mse_direct:.4f}), var(f*) {var_f:.4f}")
    check(k1_a == st.iters + 3, f"(a) K1 launched {k1_a} times in the fit, "
          f"expected {st.iters + 3}")
    check(mse_a < var_f, f"(a) test MSE {mse_a:.4f} not below {var_f:.4f}")
    out["a"] = dict(fit_s=a["fit_s"], predict_s=a["predict_s"],
                    iters=st.iters, residuals=[float(r) for r in
                                               st.residuals],
                    test_mse=mse_a, direct_test_mse=mse_direct,
                    launches=a["launches"], fit_launches=a["fit_launches"])
    del direct
    prof = _profile(lambda: SketchedKRR(cfg.replace(
        solver="falkon_pcg")).fit(Xtr, ytr))
    _profile_line("(a) falkon_pcg fit", prof, a["fit_s"])
    out["a"]["profile"] = prof
    del a

    # (b) eigenpro in memory
    m_rows = auto_batch_rows(N_TRAIN, P, 4, cfg.batch_budget_mb)
    per_epoch = math.ceil(N_TRAIN / m_rows)
    b = _run_path("b", lambda: SketchedKRR(cfg.replace(
        solver="eigenpro")).fit(Xtr, ytr),
        lambda m: m.predict_batched(Xte, batch_size=PREDICT_BATCH))
    st = b["out"].state()
    mse_b = check_fit("b", b, N_TEST)
    k1_b = b["fit_launches"]["kernel_block"]
    log(f"[iter] (b) eigenpro in memory: fit {b['fit_s']:.2f} s, "
        f"{st.iters} epochs of {per_epoch} batches of {m_rows} rows, deltas "
        f"{[round(float(r), 8) for r in st.residuals]}; K1 launches in the "
        f"fit {k1_b} (expected 3 + epochs x {per_epoch} = "
        f"{3 + st.iters * per_epoch}); test MSE {mse_b:.4f} (ratio to the "
        f"direct fit of (a) {mse_b / mse_direct:.4f})")
    check(k1_b == 3 + st.iters * per_epoch,
          f"(b) K1 launched {k1_b} times in the fit")
    check(mse_b < var_f, f"(b) test MSE {mse_b:.4f} not below {var_f:.4f}")
    out["b"] = dict(fit_s=b["fit_s"], predict_s=b["predict_s"],
                    epochs=st.iters, batch_rows=m_rows,
                    batch_launches=st.iters * per_epoch,
                    deltas=[float(r) for r in st.residuals], test_mse=mse_b,
                    launches=b["launches"], fit_launches=b["fit_launches"])
    prof = _profile(lambda: SketchedKRR(cfg.replace(
        solver="eigenpro")).fit(Xtr, ytr))
    _profile_line("(b) eigenpro fit", prof, b["fit_s"])
    out["b"]["profile"] = prof
    del b

    # (c) the streamed Theorem-4 pass alone, its peak memory and its
    # scores against the hopper pass on the same landmarks; then a
    # streaming fit
    X = torch.as_tensor(Xtr, device="cuda")
    lam_s = cfg.lam * cfg.eps
    idx = draw_landmarks(torch.Generator().manual_seed(5),
                         torch.full((N_TRAIN,), 1.0 / N_TRAIN), P)
    stream_ops = ops_for(cfg.kernel, "streaming", device="cuda",
                         block_rows=cfg.block_rows)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    streamed = fast_ridge_leverage(cfg.kernel, X, lam_s, P, idx=idx,
                                   ops=stream_ops)
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    dense = fast_ridge_leverage(cfg.kernel, X, lam_s, P, idx=idx,
                                ops=ops_for(cfg.kernel, "hopper",
                                            device="cuda"))

    def max_rel(a, b):
        return float(((a.double() - b.double()).abs() / b.abs()).max())

    rel = max_rel(streamed.scores, dense.scores)
    # both routes against the scores of float64 copies (the plain dense
    # pass), on the same landmarks
    exact = fast_ridge_leverage(cfg.kernel, X.double(), lam_s, P, idx=idx,
                                ops=ops_for(cfg.kernel, "torch",
                                            device="cuda")).scores
    rel_exact = {"streamed": max_rel(streamed.scores, exact),
                 "hopper": max_rel(dense.scores, exact)}
    del exact
    tiles = math.ceil(N_TRAIN / cfg.block_rows)
    c = _run_path("c", lambda: SketchedKRR(cfg.replace(
        backend="streaming")).fit(Xtr, ytr),
        lambda m: m.predict_batched(Xte, batch_size=PREDICT_BATCH))
    mse_c = check_fit("c", c, N_TEST)
    k1_c = c["fit_launches"]["kernel_block"]
    log(f"[iter] (c) streamed score pass (block_rows {cfg.block_rows}, "
        f"{tiles} tiles a pass): {pass_s:.3f} s, peak device memory "
        f"{peak / 1e9:.3f} GB above the {held / 1e9:.2f} GB held; scores "
        f"vs the hopper pass on the same landmarks: max rel "
        f"{rel:.3e} (tolerance {ITER_SCORES_TOL:g}); each against float64 "
        f"scores: streamed {rel_exact['streamed']:.3e}, hopper "
        f"{rel_exact['hopper']:.3e}; row_sq finite "
        f"{bool(torch.isfinite(streamed.row_sq).all())}")
    log(f"[iter] (c) streaming fit (nystrom): {c['fit_s']:.2f} s, K1 "
        f"launches in the fit {k1_c} (expected 1 + 3 x {tiles} = "
        f"{1 + 3 * tiles}), rls_scores {c['fit_launches']['rls_scores']}, "
        f"after predict {c['launches']['kernel_block']}; test MSE "
        f"{mse_c:.4f}")
    check(streamed.B is None, "(c) the streamed pass formed B")
    check(peak < 1e9, f"(c) streamed pass peak {peak / 1e9:.3f} GB >= 1 GB")
    check(rel <= ITER_SCORES_TOL, f"(c) scores {rel:.3e} > "
          f"{ITER_SCORES_TOL:g}")
    check(k1_c == 1 + 3 * tiles and c["fit_launches"]["rls_scores"] == 0,
          f"(c) launches in the fit {c['fit_launches']}")
    check(mse_c < var_f, f"(c) test MSE {mse_c:.4f} not below {var_f:.4f}")
    out["c"] = dict(pass_s=pass_s, peak_bytes=peak, held_bytes=held,
                    tile_launches=k1_c - 1,
                    scores_max_rel=rel, scores_max_rel_to_f64=rel_exact,
                    fit_s=c["fit_s"],
                    predict_s=c["predict_s"], test_mse=mse_c,
                    launches=c["launches"], fit_launches=c["fit_launches"])
    del streamed, dense, X
    prof = _profile(lambda: SketchedKRR(cfg.replace(
        backend="streaming")).fit(Xtr, ytr))
    _profile_line("(c) streaming fit", prof, c["fit_s"])
    out["c"]["profile"] = prof
    del c

    # (d) falkon_pcg out of core on the RCV1-shaped rows, against the
    # chunked nystrom_regularized fit with the same draws
    rc = _rcv1(keep)
    scfg = SketchConfig(RBFKernel(RCV1_BANDWIDTH), p=P, lam=LAM,
                        chunk_rows=CHUNK_ROWS, solver="falkon_pcg",
                        precision=Precision(**SPARSE_PRECISION))
    d = _run_path("d", lambda: SketchedKRR(scfg).fit(rc["train"], rc["y"]),
                  lambda m: m.predict(rc["test"]))
    mse_d = check_fit("d", d, RCV1_TEST)
    ref_d = SketchedKRR(scfg.replace(solver="nystrom_regularized")).fit(
        rc["train"], rc["y"], sample=d["out"].sample())
    b_d, b_ref = d["out"].state().beta, ref_d.state().beta
    rel_d = float(torch.linalg.norm(b_d - b_ref) / torch.linalg.norm(b_ref))
    chunks = math.ceil(RCV1_TRAIN / CHUNK_ROWS)
    k3_d = d["fit_launches"]["sparse_cross"]
    log(f"[iter] (d) falkon_pcg out of core (RCV1 shape, chunk_rows "
        f"{CHUNK_ROWS}): fit {d['fit_s']:.2f} s, {d['out'].state().iters} "
        f"iterations; K3 launches in the fit {k3_d} (expected 3 x {chunks}), "
        f"launches after predict {d['launches']}; beta vs the chunked "
        f"nystrom_regularized beta with the same draws: {rel_d:.3e} "
        f"(tolerance {ITER_BETA_TOL:g}); test MSE {mse_d:.4f} against "
        f"var(f*) {float(torch.var(torch.as_tensor(rc['f_test']))):.4f}")
    check(k3_d == 3 * chunks, f"(d) K3 launched {k3_d} times in the fit")
    check(rel_d <= ITER_BETA_TOL, f"(d) beta {rel_d:.3e} > {ITER_BETA_TOL}")
    out["d"] = dict(fit_s=d["fit_s"], predict_s=d["predict_s"],
                    iters=d["out"].state().iters, beta_rel_to_direct=rel_d,
                    test_mse=mse_d, launches=d["launches"],
                    fit_launches=d["fit_launches"])
    del ref_d
    prof = _profile(lambda: SketchedKRR(scfg).fit(rc["train"], rc["y"]))
    _profile_line("(d) falkon_pcg out-of-core fit", prof, d["fit_s"])
    out["d"]["profile"] = prof
    del d

    # (e) eigenpro through fit(ArrayChunkSource): the end_pass protocol
    src = _counting_source(Xtr, ytr, CHUNK_ROWS)
    e = _run_path("e", lambda: SketchedKRR(cfg.replace(
        solver="eigenpro")).fit(src),
        lambda m: m.predict_batched(Xte, batch_size=PREDICT_BATCH))
    mse_e = check_fit("e", e, N_TEST)
    st = e["out"].state()
    log(f"[iter] (e) eigenpro via fit(ArrayChunkSource, chunk_rows "
        f"{CHUNK_ROWS}): fit {e['fit_s']:.2f} s, {src.passes} passes over "
        f"the source, {st.iters} epochs, deltas "
        f"{[round(float(r), 8) for r in st.residuals]}; launches in the fit "
        f"{e['fit_launches']}; test MSE {mse_e:.4f}")
    check(src.passes == 6 + st.iters,
          f"(e) {src.passes} passes for {st.iters} epochs")
    check(e["fit_launches"]["kernel_block"] > st.iters,
          f"(e) K1 launched {e['fit_launches']['kernel_block']} times")
    check(mse_e < var_f, f"(e) test MSE {mse_e:.4f} not below {var_f:.4f}")
    out["e"] = dict(fit_s=e["fit_s"], predict_s=e["predict_s"],
                    passes=src.passes, epochs=st.iters, test_mse=mse_e,
                    launches=e["launches"], fit_launches=e["fit_launches"])
    prof = _profile(lambda: SketchedKRR(cfg.replace(solver="eigenpro")).fit(
        _counting_source(Xtr, ytr, CHUNK_ROWS)))
    _profile_line("(e) eigenpro out-of-core fit", prof, e["fit_s"])
    out["e"]["profile"] = prof
    del e

    # (f) hopper against torch at n = 20,000 with the same draws (and, for
    # eigenpro, the same seed: the same subsample). Predictions are held at
    # the test rows and at the training rows; β wherever the float32
    # system determines it (ITER_FREE_BETA)
    Xp, yp, Xq = Xtr[:N_PARITY], ytr[:N_PARITY], Xte[:N_PARITY_TEST]
    idx = draw_landmarks(torch.Generator().manual_seed(3),
                         torch.full((N_PARITY,), 1.0 / N_PARITY), P)
    tols = dict(PARITY_TOL, train_predictions=PARITY_TOL["predictions"],
                scores=ITER_PARITY_SCORES_TOL)
    out["f"] = {}
    for label, kw in [("falkon_pcg", dict(solver="falkon_pcg")),
                      ("eigenpro", dict(solver="eigenpro")),
                      ("streaming", dict(backend="streaming"))]:
        c1 = cfg.replace(**kw)
        fast = c1.replace(backend=kw.get("backend", "hopper"))
        hop = SketchedKRR(fast).fit(Xp, yp, score_landmarks=idx)
        plain = SketchedKRR(c1.replace(backend="torch")).fit(
            Xp, yp, score_landmarks=idx, sample=hop.sample())
        errs = {}
        for key, rows in (("predictions", Xq), ("train_predictions", Xp)):
            y_h, y_t = hop.predict(rows), plain.predict(rows)
            errs[key] = float((y_h - y_t).abs().max() / y_t.abs().max())
        b_h, b_t = hop.state().beta, plain.state().beta
        errs["beta"] = float(torch.linalg.norm(b_h - b_t)
                             / torch.linalg.norm(b_t))
        if label == "streaming":
            s_h, s_t = hop.scores(), plain.scores()
            errs["scores"] = float(((s_h - s_t).abs() / s_t.abs()).max())
        held = [k for k in errs if (label, k) not in ITER_FREE_BETA]
        iters = getattr(hop.state(), "iters", None)
        log(f"[iter] (f) {label} {fast.backend} vs torch at n={N_PARITY}: "
            + ", ".join(f"{k} {v:.3e} (tolerance {tols[k]:g})" if k in held
                        else f"{k} {v:.3e} (logged, not held)"
                        for k, v in errs.items())
            + ("" if iters is None else
               f"; iterations {iters} vs {plain.state().iters}"))
        for k in held:
            check(errs[k] <= tols[k], f"(f) {label} {k}: {errs[k]:.3e} > "
                  f"{tols[k]:g}")
        out["f"][label] = errs

# --------------------------------------------------- samplers and serving

class _Timed:
    """For the length of a ``with``: every call of ``module.name``
    synchronised on both sides and timed, with ``record(args, result)``'s
    fields and the kernel launches it made (a stage of a sampler)."""

    def __init__(self, module, name: str, record):
        self.module, self.name, self.record = module, name, record
        self.calls: list[dict] = []

    def __enter__(self) -> "_Timed":
        import torch
        from repro_torch.kernels import ops as kops
        self._inner = inner = getattr(self.module, self.name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            before = kops.launch_counts()
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            after = kops.launch_counts()
            self.calls.append(dict(self.record(a, out), seconds=seconds,
                                   launches={k: after[k] - before[k]
                                             for k in after}))
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self._inner)


def _stage_lines(tag: str, calls: list[dict]) -> None:
    for h, c in enumerate(calls):
        log(f"[samplers] {tag} stage {h + 1:2d}: lambda {c['lam']:.3e}, "
            f"q {c['q']:4d}, d_eff estimate {c['d_eff']:.2f}, "
            f"{c['seconds']:.3f} s, launches {c['launches']}")


def _serving_copy(model):
    """A model that holds only ``model``'s O(p) serving state (what the
    serve plane needs; the O(n·p) training factor stays behind)."""
    from repro_torch.api import SketchedKRR
    return SketchedKRR(model.config).import_serving_state(
        model.export_serving_state())


def _msd_rls_fast(keep: dict):
    """The main path's rls_fast / nystrom model of the MSD rows (phase
    main's serving state, or fitted here when main did not run) and its
    test MSE."""
    if "msd_model" not in keep:
        from repro_torch.api import RBFKernel, SketchConfig, SketchedKRR
        Xtr, ytr, Xte, fte = _msd(keep)
        model = SketchedKRR(SketchConfig(RBFKernel(BANDWIDTH), p=P,
                                         lam=LAM)).fit(Xtr, ytr)
        keep["msd_mse"] = _mse(model.predict_batched(
            Xte, batch_size=PREDICT_BATCH), fte)
        keep["msd_model"] = _serving_copy(model)
    return keep["msd_model"], keep["msd_mse"]


def _counting_sparse_source(X, y, chunk_rows: int):
    """A ``SparseChunkSource`` that counts its ``chunks()`` calls (passes;
    every pass uploads each chunk once)."""
    from repro_torch.data import SparseChunkSource

    class Counting(SparseChunkSource):
        passes = 0

        def chunks(self):
            self.passes += 1
            return super().chunks()

    return Counting(X, y, chunk_rows)


def _score_pass_precision(keep: dict) -> dict:
    """The in-memory hopper score pass at the MSD cell (the uniform
    landmarks of phase iter (c)) against float64 scores: the default
    policy, Precision(accum_dtype="f64") throughout, and the 2 x 2 of
    {float32, float64} BᵀB x {3xTF32, float64-accumulating} K2 on the
    default route's B — which of the two sets the error."""
    import torch
    from repro_torch.api import Precision, RBFKernel
    from repro_torch.core.backends import ops_for
    from repro_torch.core.leverage import draw_landmarks, fast_ridge_leverage
    kernel, lam_s = RBFKernel(BANDWIDTH), LAM * 0.5
    X = torch.as_tensor(_msd(keep)[0], device="cuda")
    n = X.shape[0]
    idx = draw_landmarks(torch.Generator().manual_seed(5),
                         torch.full((n,), 1.0 / n), P)
    hop = ops_for(kernel, "hopper", device="cuda")
    wide = ops_for(kernel, "hopper", device="cuda",
                   precision=Precision(accum_dtype="f64"))
    exact = fast_ridge_leverage(kernel, X.double(), lam_s, P, idx=idx,
                                ops=ops_for(kernel, "torch",
                                            device="cuda")).scores

    def rel(s):
        return float(((s.double() - exact).abs() / exact.abs()).max())

    out = {"accum_f64_route": rel(fast_ridge_leverage(
        kernel, X, lam_s, P, idx=idx, ops=wide).scores)}
    default = fast_ridge_leverage(kernel, X, lam_s, P, idx=idx, ops=hop)
    out["default_route"] = rel(default.scores)
    B = default.B
    del default
    G32 = B.T @ B
    Bw = B.double()
    G64 = Bw.T @ Bw
    del Bw
    for gname, G in (("gram_f32", G32), ("gram_f64", G64)):
        for kname, ops in (("k2_tf32x3", hop), ("k2_f64acc", wide)):
            out[f"{gname}+{kname}"] = rel(ops.scores_given_gram(B, G,
                                                                lam_s, n))
    del B, G32, G64, exact, X
    torch.cuda.empty_cache()
    return out


def phase_samplers(res: dict, keep: dict) -> None:
    """The bless and recursive_rls samplers and the dnc solver at full
    width: (a) bless in memory on the MSD rows, (b) bless out of core on
    the RCV1 rows (K3), (c) recursive_rls, (d) dnc with 35 partitions of
    13,249 rows, (e) hopper against torch at n = 20,000 with the same
    draws; then the score pass's precision study."""
    import torch
    import repro_torch.core.bless as tbless
    import repro_torch.core.recursive_rls as trec
    from repro_torch.api import (Precision, RBFKernel, SketchConfig,
                                 SketchedKRR)
    from repro_torch.api import out_of_core
    from repro_torch.core.dnc import dnc_kernel_evals
    Xtr, ytr, Xte, fte = _msd(keep)
    out: dict = {}
    res["samplers"] = out
    var_f = float(torch.var(torch.as_tensor(fte)))
    cfg = SketchConfig(RBFKernel(BANDWIDTH), p=P, lam=LAM)
    rls_model, mse_rls = _msd_rls_fast(keep)

    def stage(a, r):
        return dict(lam=float(a[2]), q=int(r.landmarks.numel()),
                    d_eff=float(r.d_eff_estimate))

    def check_fit(tag, run, f_test, n_test):
        yhat = run["yhat"]
        check(yhat.shape == (n_test,), f"({tag}) predictions shape")
        check(bool(torch.isfinite(yhat).all()),
              f"({tag}) non-finite predictions")
        return _mse(yhat, f_test)

    # (a) bless, in memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with _Timed(tbless, "fast_ridge_leverage", stage) as st:
        a = _run_path("a", lambda: SketchedKRR(cfg.replace(
            sampler="bless")).fit(Xtr, ytr),
            lambda m: m.predict_batched(Xte, batch_size=PREDICT_BATCH))
    peak = torch.cuda.max_memory_allocated() - held
    _stage_lines("(a)", st.calls)
    mse_a = check_fit("a", a, fte, N_TEST)
    stages = len(st.calls)
    fl = a["fit_launches"]
    log(f"[samplers] (a) bless in memory: {stages} stages, fit "
        f"{a['fit_s']:.2f} s (stages {sum(c['seconds'] for c in st.calls):.2f}"
        f" s), launches in the fit {fl} (expected K1 stages + 1 = "
        f"{stages + 1}, K2 {stages}), after predict "
        f"{a['launches']['kernel_block']}; peak device memory "
        f"{peak / 1e9:.2f} GB above the {held / 1e9:.2f} GB held; test MSE "
        f"{mse_a:.4f}, rls_fast {mse_rls:.4f} (ratio "
        f"{mse_a / mse_rls:.4f}), var(f*) {var_f:.4f}")
    check(stages >= 2 and st.calls[-1]["lam"] == LAM * cfg.eps,
          f"(a) schedule {[c['lam'] for c in st.calls]}")
    check(all(c["q"] <= P for c in st.calls), "(a) a dictionary above p")
    check(fl["kernel_block"] == stages + 1 and fl["rls_scores"] == stages,
          f"(a) launches in the fit {fl}")
    check(mse_a < var_f, f"(a) test MSE {mse_a:.4f} not below {var_f:.4f}")
    out["a"] = dict(fit_s=a["fit_s"], predict_s=a["predict_s"],
                    stages=st.calls, peak_bytes=peak, held_bytes=held,
                    test_mse=mse_a, rls_fast_test_mse=mse_rls,
                    launches=a["launches"], fit_launches=fl)
    keep["bless_model"] = _serving_copy(a["out"])
    del a
    prof = _profile(lambda: SketchedKRR(cfg.replace(sampler="bless")).fit(
        Xtr, ytr))
    _profile_line("(a) bless fit", prof, out["a"]["fit_s"], "samplers")
    out["a"]["profile"] = prof

    # (b) bless out of core on the RCV1 rows (K3)
    rc = _rcv1(keep)
    scfg = SketchConfig(RBFKernel(RCV1_BANDWIDTH), p=P, lam=LAM,
                        chunk_rows=CHUNK_ROWS, sampler="bless",
                        precision=Precision(**SPARSE_PRECISION))
    src = _counting_sparse_source(rc["train"], rc["y"], CHUNK_ROWS)

    def ooc_stage(a, r):
        return dict(lam=float(a[4]), q=int(a[2].shape[0]),
                    d_eff=float(torch.sum(r[0])))

    with _Timed(out_of_core, "chunked_score_pass", ooc_stage) as st:
        b = _run_path("b", lambda: SketchedKRR(scfg).fit(src),
                      lambda m: m.predict(rc["test"]))
    _stage_lines("(b)", st.calls)
    mse_b = check_fit("b", b, rc["f_test"], RCV1_TEST)
    stages = len(st.calls)
    chunks = -(-RCV1_TRAIN // CHUNK_ROWS)
    fl = b["fit_launches"]
    mse_sparse = res.get("sparse", {}).get("test_mse")
    log(f"[samplers] (b) bless out of core (RCV1 shape, chunk_rows "
        f"{CHUNK_ROWS}): {stages} stages, fit {b['fit_s']:.2f} s, {src.passes}"
        f" passes over the source ({src.passes * chunks} chunk uploads; "
        f"expected 3 x stages + 3 = {3 * stages + 3} passes); launches in the "
        f"fit {fl} (K3 expected 2 x {chunks} chunks x stages + {chunks} = "
        f"{2 * chunks * stages + chunks}, K1 stages + 1 = {stages + 1}); test "
        f"MSE {mse_b:.4f}, rls_fast sparse fit "
        f"{'not run' if mse_sparse is None else f'{mse_sparse:.4f}'}")
    check(fl["sparse_cross"] == 2 * chunks * stages + chunks,
          f"(b) K3 launched {fl['sparse_cross']} times")
    check(fl["kernel_block"] == stages + 1 and fl["rls_scores"] == 0,
          f"(b) launches in the fit {fl}")
    check(src.passes == 3 * stages + 3, f"(b) {src.passes} passes")
    check(mse_b < float(torch.var(torch.as_tensor(rc["f_test"]))),
          f"(b) test MSE {mse_b:.4f}")
    out["b"] = dict(fit_s=b["fit_s"], predict_s=b["predict_s"],
                    stages=st.calls, passes=src.passes,
                    chunk_uploads=src.passes * chunks, test_mse=mse_b,
                    rls_fast_test_mse=mse_sparse, launches=b["launches"],
                    fit_launches=fl)
    del b
    prof = _profile(lambda: SketchedKRR(scfg).fit(rc["train"], rc["y"]))
    _profile_line("(b) bless out-of-core fit", prof, out["b"]["fit_s"],
                  "samplers")
    out["b"]["profile"] = prof

    # (c) recursive_rls, in memory
    with _Timed(trec, "fast_ridge_leverage", stage) as st:
        c = _run_path("c", lambda: SketchedKRR(cfg.replace(
            sampler="recursive_rls")).fit(Xtr, ytr),
            lambda m: m.predict_batched(Xte, batch_size=PREDICT_BATCH))
    _stage_lines("(c) level", st.calls)
    mse_c = check_fit("c", c, fte, N_TEST)
    fl = c["fit_launches"]
    log(f"[samplers] (c) recursive_rls ({cfg.rls_levels} levels): fit "
        f"{c['fit_s']:.2f} s, launches in the fit {fl}; test MSE "
        f"{mse_c:.4f} (rls_fast {mse_rls:.4f})")
    check(fl["kernel_block"] == cfg.rls_levels + 1
          and fl["rls_scores"] == cfg.rls_levels, f"(c) launches {fl}")
    check(mse_c < var_f, f"(c) test MSE {mse_c:.4f} not below {var_f:.4f}")
    out["c"] = dict(fit_s=c["fit_s"], predict_s=c["predict_s"],
                    levels=st.calls, test_mse=mse_c, launches=c["launches"],
                    fit_launches=fl)
    del c
    prof = _profile(lambda: SketchedKRR(cfg.replace(
        sampler="recursive_rls")).fit(Xtr, ytr))
    _profile_line("(c) recursive_rls fit", prof, out["c"]["fit_s"],
                  "samplers")
    out["c"]["profile"] = prof

    # (d) dnc: 463,715 = 35 x 13,249, every row in a partition
    m = DNC_PARTITIONS
    dcfg = cfg.replace(solver="dnc", partitions=m)
    d = _run_path("d", lambda: SketchedKRR(dcfg).fit(Xtr, ytr),
                  lambda mdl: mdl.predict(Xte))
    mse_d = check_fit("d", d, fte, N_TEST)
    evals, nys = dnc_kernel_evals(N_TRAIN, m), N_TRAIN * P
    fl = d["fit_launches"]
    log(f"[samplers] (d) dnc, {m} partitions of {N_TRAIN // m} rows: fit "
        f"{d['fit_s']:.2f} s, predict {d['predict_s']:.2f} s, launches in "
        f"the fit {fl}, after predict {d['launches']}; kernel evaluations "
        f"n^2/m = {evals:.3e} against Nystrom's n.p = {nys:.3e} "
        f"({evals / nys:.2f}x); test MSE {mse_d:.4f} (rls_fast "
        f"{mse_rls:.4f}), var(f*) {var_f:.4f}")
    check(fl["kernel_block"] == m and d["launches"]["kernel_block"] == 2 * m,
          f"(d) launches {d['launches']}")
    check(mse_d < var_f, f"(d) test MSE {mse_d:.4f} not below {var_f:.4f}")
    out["d"] = dict(fit_s=d["fit_s"], predict_s=d["predict_s"],
                    partitions=m, kernel_evals=evals,
                    nystrom_kernel_evals=nys, test_mse=mse_d,
                    launches=d["launches"], fit_launches=fl)
    del d
    prof = _profile(lambda: SketchedKRR(dcfg).fit(Xtr, ytr))
    _profile_line("(d) dnc fit", prof, out["d"]["fit_s"], "samplers")
    out["d"]["profile"] = prof
    torch.cuda.empty_cache()

    # (e) hopper against torch at n = 20,000, the hopper fit's draws
    # injected into the torch fit
    Xp, yp, Xq = Xtr[:N_PARITY], ytr[:N_PARITY], Xte[:N_PARITY_TEST]
    out["e"] = {}
    for label, kw, module in [
            ("bless", dict(sampler="bless"), tbless),
            ("recursive_rls", dict(sampler="recursive_rls"), trec),
            ("dnc", dict(solver="dnc", partitions=5), None)]:
        c1 = cfg.replace(**kw)
        if module is None:
            hop = SketchedKRR(c1.replace(backend="hopper")).fit(Xp, yp)
            draws = dict(partitions=hop.state().model.partitions)
        else:
            with _Timed(module, "fast_ridge_leverage",
                        lambda a, r: dict(idx=r.landmarks)) as st:
                hop = SketchedKRR(c1.replace(backend="hopper")).fit(Xp, yp)
            draws = dict(score_landmarks=[c["idx"] for c in st.calls],
                         sample=hop.sample())
        plain = SketchedKRR(c1.replace(backend="torch")).fit(Xp, yp, **draws)
        y_h, y_t = hop.predict(Xq), plain.predict(Xq)
        errs = {"predictions": float((y_h - y_t).abs().max()
                                     / y_t.abs().max())}
        if module is None:
            a_h, a_t = hop.state().model.alphas, plain.state().model.alphas
            errs["beta"] = float(torch.linalg.norm(a_h - a_t)
                                 / torch.linalg.norm(a_t))
        else:
            b_h, b_t = hop.state().beta, plain.state().beta
            errs["beta"] = float(torch.linalg.norm(b_h - b_t)
                                 / torch.linalg.norm(b_t))
            s_h, s_t = hop.scores(), plain.scores()
            errs["scores"] = float(((s_h - s_t).abs() / s_t.abs()).max())
        log(f"[samplers] (e) {label} hopper vs torch at n={N_PARITY}: "
            + ", ".join(f"{k} {v:.3e} (tolerance {PARITY_TOL[k]:g})"
                        for k, v in errs.items()))
        for k, v in errs.items():
            check(v <= PARITY_TOL[k], f"(e) {label} {k}: {v:.3e} > "
                  f"{PARITY_TOL[k]:g}")
        out["e"][label] = errs
    del hop, plain

    # the score pass's precision at the MSD cell (PERF.md §7)
    study = _score_pass_precision(keep)
    log("[samplers] score pass at the MSD cell, max relative error against "
        "float64 scores on the same landmarks: "
        + ", ".join(f"{k} {v:.3e}" for k, v in study.items()))
    out["score_pass_precision"] = study


def _serve_clients(eng, X, rows, keys, threads: int = 4, pace=None):
    """``threads`` client threads submitting one request a row of X (row i
    to ``keys[i % len(keys)]``), each thread every ``threads``-th of
    ``rows``, calling ``pace()`` after every 64 submissions; returns
    [(row, key, future)] and the seconds the submissions took."""
    import threading
    subs: list[list] = [[] for _ in range(threads)]

    def client(t):
        for j, i in enumerate(rows[t::threads]):
            key = keys[int(i) % len(keys)]
            subs[t].append((int(i), key, eng.submit(X[int(i)], model=key)))
            if pace is not None and j % 64 == 63:
                pace()
    ths = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for th in ths:
        th.start()
    for th in ths:
        th.join(600)
    return [s for sub in subs for s in sub], time.perf_counter() - t0


def phase_serve(res: dict, keep: dict) -> None:
    """The async serve plane on the card, serving two keys (the MSD rls_fast
    model and the bless model of phase samplers (a)): (i) throughput, four
    client threads submitting the 51,630 test rows as single-row requests;
    (ii) a hot swap under load, a BackgroundRefresher publishing refreshed
    rls_fast duals while requests run; then KRRServeEngine draining the
    rows in micro-batches of 256."""
    import collections
    import numpy as np
    import torch
    from repro_torch.api import RBFKernel, SketchConfig, SketchedKRR
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime import KRRRequest, KRRServeEngine
    from repro_torch.serve import (AsyncServeEngine, BackgroundRefresher,
                                   BatchPolicy, ModelSlot)
    Xtr, ytr, Xte, fte = _msd(keep)
    cfg = SketchConfig(RBFKernel(BANDWIDTH), p=P, lam=LAM)
    rls, _ = _msd_rls_fast(keep)
    if "bless_model" not in keep:
        keep["bless_model"] = _serving_copy(SketchedKRR(cfg.replace(
            sampler="bless")).fit(Xtr, ytr))
    models = {"rls_fast": rls, "bless": keep["bless_model"]}
    keys = ("rls_fast", "bless")
    out: dict = {}
    res["serve"] = out
    # each answer against predict of its row: the K1 blocks of the two
    # shapes agree to the float32 block tolerance, so an answer may move by
    # that much of each term of its contraction, Σ_j |k(x, z_j) β_j|
    want, scale = {}, {}
    for key, mdl in models.items():
        st = mdl.state()
        want[key] = mdl.predict(Xte).cpu().numpy()
        scale[key] = mdl.ops().matvec(torch.as_tensor(Xte, device="cuda"),
                                      st.landmarks, st.beta.abs()
                                      ).cpu().numpy()
    torch.cuda.synchronize()

    # (i) throughput
    policy = BatchPolicy(max_batch=256, max_wait_ms=2.0)

    def run_i():
        eng = AsyncServeEngine(models, policy=policy)
        with eng:
            subs, submit_s = _serve_clients(eng, Xte, np.arange(N_TEST),
                                            keys)
            got = [(i, k, f.result(60)) for i, k, f in subs]
        return eng, got, submit_s

    run_i()                                  # warm-up: each bucket once
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    eng, got, submit_s = run_i()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    stats = eng.stats()
    worst = {k: 0.0 for k in keys}
    worst_rel = {k: 0.0 for k in keys}
    for i, k, r in got:
        dev = abs(r.y_hat - float(want[k][i]))
        worst[k] = max(worst[k], dev)
        worst_rel[k] = max(worst_rel[k], dev / float(scale[k][i]))
    buckets = dict(sorted(collections.Counter(stats.buckets).items()))
    log(f"[serve] (i) {N_TEST} single-row requests from 4 threads over keys "
        f"{keys}: {N_TEST / wall:.0f} requests/s ({wall:.2f} s, submissions "
        f"{submit_s:.2f} s); latency p50 {stats.p50():.2f} ms, p99 "
        f"{stats.p99():.2f} ms; {stats.batches} batches by bucket {buckets}; "
        f"K1 launches {counts['kernel_block']} (one a batch); misses "
        f"{stats.misses}, shed {stats.shed}; max |answer - predict| "
        f"{worst} = {worst_rel} of sum_j |k_j beta_j| (tolerance "
        f"{K1_TOL['float32']:g})")
    check(stats.served == N_TEST and len(got) == N_TEST,
          f"(i) served {stats.served} of {N_TEST}")
    check(stats.misses == 0 and stats.shed == 0, f"(i) misses / shed")
    check(counts["kernel_block"] == stats.batches,
          f"(i) K1 launched {counts['kernel_block']} times for "
          f"{stats.batches} batches")
    for k in keys:
        check(worst_rel[k] <= K1_TOL["float32"],
              f"(i) {k} answers {worst_rel[k]:.3e} from predict")
    out["i"] = dict(requests=N_TEST, wall_s=wall, submit_s=submit_s,
                    requests_per_s=N_TEST / wall, p50_ms=stats.p50(),
                    p99_ms=stats.p99(), batches=stats.batches,
                    buckets=buckets, launches=counts,
                    max_abs_dev=worst, max_rel_dev=worst_rel)
    del got
    prof = _profile(run_i)
    _profile_line("(i) serve", prof, wall, "serve")
    out["i"]["profile"] = prof

    # (ii) the hot swap: one bucket, a deadline on every request; a
    # BackgroundRefresher publishes refreshed rls_fast duals (partial_fit
    # over one chunk of CHUNK_ROWS training rows, then finalize) while four
    # threads keep submitting
    class Keeping(BackgroundRefresher):
        """Keeps the snapshot of each version it published (the model's
        state right after the publish, as a slot of its own)."""

        def ingest(self, X, y):
            version = super().ingest(X, y)
            self.snaps[version] = ModelSlot(self.model).current()
            return version

    BUCKET = 256
    policy = BatchPolicy(max_batch=BUCKET, max_wait_ms=2.0, buckets=(BUCKET,),
                         default_deadline_ms=SERVE_DEADLINE_MS)
    eng = AsyncServeEngine(models, policy=policy)
    refresher = Keeping(eng, SketchedKRR(cfg), key="rls_fast")
    refresher.snaps = {1: ModelSlot(rls).current()}
    chunks = [(Xtr[i * CHUNK_ROWS:(i + 1) * CHUNK_ROWS],
               ytr[i * CHUNK_ROWS:(i + 1) * CHUNK_ROWS]) for i in range(3)]
    rows, edge = np.arange(N_TEST), min(2048, N_TEST // 8)
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    with eng:
        # wave A on version 1, wave B while the refresher publishes, wave C
        # after it has published its last version
        wave_a = [(i, "rls_fast", eng.submit(Xte[i], model="rls_fast"))
                  for i in range(edge)]
        wave_a = [(i, k, f.result(60)) for i, k, f in wave_a]
        refresher.start(chunks)
        wave_b, _ = _serve_clients(eng, Xte, rows[edge:N_TEST - edge],
                                   ("rls_fast",),
                                   pace=lambda: time.sleep(0.008))
        wave_b = [(i, k, f.result(60)) for i, k, f in wave_b]
        refresher.join(timeout=300)
        wave_c = [(i, "rls_fast", eng.submit(Xte[i], model="rls_fast"))
                  for i in range(N_TEST - edge, N_TEST)]
        wave_c = [(i, k, f.result(60)) for i, k, f in wave_c]
    wall = time.perf_counter() - t0
    stats = eng.stats()
    results = wave_a + wave_b + wave_c
    by_version = collections.defaultdict(list)
    for i, _, r in results:
        by_version[r.version].append((i, r.y_hat))
    unequal = 0
    for version, pairs in by_version.items():
        snap = refresher.snaps[version]
        for s in range(0, len(pairs), BUCKET):
            part = pairs[s:s + BUCKET]
            ref = snap.predict_padded(Xte[[i for i, _ in part]], BUCKET)
            unequal += sum(float(v) != y for v, (_, y) in zip(ref, part))
    served = {v: len(p) for v, p in sorted(by_version.items())}
    log(f"[serve] (ii) hot swap: {len(results)} requests in {wall:.2f} s "
        f"while the refresher published versions {refresher.versions}; "
        f"answers by version {served}; {unequal} answers not bit-equal to "
        f"their snapshot's predict_padded at bucket {BUCKET}; misses "
        f"{stats.misses}, p50 {stats.p50():.2f} ms, p99 {stats.p99():.2f} "
        f"ms, launches {kops.launch_counts()}")
    check(len(results) == N_TEST and stats.served == N_TEST,
          f"(ii) served {stats.served} of {N_TEST}")
    check(refresher.versions == [2, 3, 4],
          f"(ii) published {refresher.versions}")
    check(len(served) >= 2, f"(ii) versions served {served}")
    check(all(r.version == 1 for _, _, r in wave_a)
          and all(r.version == 4 for _, _, r in wave_c),
          "(ii) waves A and C served from the wrong version")
    check(unequal == 0, f"(ii) {unequal} answers differ from their "
          "snapshot")
    check(stats.misses == 0, f"(ii) {stats.misses} deadline misses")
    out["ii"] = dict(requests=len(results), wall_s=wall,
                     published=refresher.versions, served_by_version=served,
                     not_bit_equal=unequal, misses=stats.misses,
                     p50_ms=stats.p50(), p99_ms=stats.p99())

    # the synchronous micro-batcher over the same rows
    sync = KRRServeEngine(rls, batch_size=BUCKET)
    for i in range(N_TEST):
        sync.submit(KRRRequest(i, Xte[i]))
    t0 = time.perf_counter()
    done = sync.run(max_steps=N_TEST)
    sync_s = time.perf_counter() - t0
    batched = rls.predict_batched(Xte, batch_size=BUCKET).cpu().numpy()
    diff = max(abs(r.y_hat - float(batched[r.uid])) for r in done)
    log(f"[serve] KRRServeEngine(batch_size={BUCKET}): {len(done)} requests "
        f"in {sync_s:.2f} s ({len(done) / sync_s:.0f} requests/s); max "
        f"|answer - predict_batched({BUCKET})| {diff:.3e}")
    check(len(done) == N_TEST and diff == 0.0,
          f"KRRServeEngine: {len(done)} answers, max deviation {diff:.3e}")
    out["sync"] = dict(requests=len(done), wall_s=sync_s, max_abs_dev=diff)


# ------------------------------------------------------- phase bf16

def _bf16_share(got, want, rtol: float, atol) -> tuple[float, float]:
    """(max |got − want|, the largest share of its tolerance
    rtol·|want| + atol that an element uses), in float32."""
    import torch
    err = (got.float() - want.float()).abs()
    bound = rtol * want.float().abs() + atol
    return float(err.max()), float(torch.max(err / bound))


def _bf16_k1_plain(X, Z, kind: str, acc, **kw):
    """K1's plain version on bf16 operands: the block in ``acc``, rounded
    to bf16 once (``kernels.ops``' plain route)."""
    import torch
    from repro_torch.kernels import ref
    Xa, Za = X.to(acc), Z.to(acc)
    if kind == "rbf":
        out = ref.rbf_block_ref(Xa, Za, kw["bandwidth"])
    elif kind == "linear":
        out = ref.linear_block_ref(Xa, Za)
    else:
        out = ref.poly_block_ref(Xa, Za, kw["degree"], kw["scale"],
                                 kw["offset"])
    return out.to(torch.bfloat16)


def _bf16_kernel_checks(res: dict, keep: dict) -> dict:
    """The three bf16 instances against their plain versions on the card,
    at ragged shapes and at the shapes of the phase's paths; each cell's
    largest share of its tolerance (the margin is its inverse)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rbf_block import kernel_block
    from repro_torch.kernels.rls_scores import rls_scores_fused
    from repro_torch.kernels.sparse_block import (prepare_landmarks,
                                                  sparse_cross)
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)
    shares: dict = {}

    def note(key, err, share, what):
        log(f"[bf16] {key} {what} max|Δ|={err:.3e}, {share:.3f} of the "
            f"tolerance ({1 / max(share, 1e-30):.1f}x inside)")
        check(share <= 1.0, f"bf16 {key}: {share:.3f} of its tolerance")
        shares[key] = max(shares.get(key, 0.0), share)

    kinds = {"rbf": dict(bandwidth=1.0), "linear": {},
             "poly": dict(degree=3, scale=1.0, offset=1.0)}
    # K1: d odd (2-byte rows), the MSD rows' 90 (4-byte), d = 4096
    # (16-byte); f32 accumulation (bf16 tensor cores) and f64 (FP64 ones)
    for n, p, d in [(1031, 257, 90), (8, 8, 1), (300, 129, 17),
                    (4096, 2048, 90), (1031, 300, 4096),
                    (PREDICT_BATCH, P, DIM), (1, P, DIM)]:
        X = (torch.randn(n, d, generator=g, device="cuda") / d ** 0.5).to(bf)
        Z = (torch.randn(p, d, generator=g, device="cuda") / d ** 0.5).to(bf)
        for acc in (torch.float32, torch.float64):
            for kind, kw in kinds.items():
                got = kernel_block(X, Z, kind=kind, acc_dtype=acc, **kw)
                check(got.dtype == bf and got.shape == (n, p),
                      f"k1 bf16 returned {got.dtype} {tuple(got.shape)}")
                want = _bf16_k1_plain(X, Z, kind, acc, **kw)
                err, share = _bf16_share(got, want, BF16_STEP,
                                         K1_TOL["float32"])
                note(f"K1.{kind}.acc_{str(acc)[6:]}", err, share,
                     f"(n,p,d)=({n},{p},{d})")
    # K1 at the sparse cell's W = k(Z, Z) over bf16 landmark rows
    _, Zs = _full_chunk(keep)
    Zb = Zs.to(bf)
    for kind in ("rbf", "linear"):
        kw = dict(bandwidth=RCV1_BANDWIDTH) if kind == "rbf" else {}
        got = kernel_block(Zb, Zb, kind=kind, **kw)
        err, share = _bf16_share(got, _bf16_k1_plain(Zb, Zb, kind,
                                                     torch.float32, **kw),
                                 BF16_STEP, K1_TOL["float32"])
        note(f"K1.{kind}.W", err, share, f"W {tuple(got.shape)} d={RCV1_DIM}")
    # K2: bf16 B, M in the accumulation dtype
    for p in (37, 600, 2048):
        B, M = _scores_problem(5003, p, bf, g)
        for acc in (torch.float32, torch.float64):
            got = rls_scores_fused(B, M, acc_dtype=acc)
            check(got.dtype == bf, f"k2 bf16 returned {got.dtype}")
            want = ref.rls_scores_ref(B.to(acc), M.to(acc)).to(bf)
            err, share = _bf16_share(got, want, BF16_STEP + K2_RTOL[
                "float32"], 1e-6)
            note(f"K2.acc_{str(acc)[6:]}", err, share, f"(n,p)=(5003,{p})")
    # K3: ragged CSR against dense landmarks and landmark rows, and one
    # full chunk of the sparse cell against its landmark rows
    rng = np.random.default_rng(12)
    X = _ragged_csr(rng, torch.float32)
    Xb = type(X)(X.data.to(bf), X.indices, X.indptr, X.n_cols)
    cases = [("ragged", Xb, torch.as_tensor(
                 rng.standard_normal((257, 5000)) / 50 ** 0.5,
                 device="cuda").to(bf), 8.0),
             ("ragged, landmark rows", Xb,
              _ragged_csr(rng, torch.float32).todense()[:257].to(bf)
              .contiguous(), 1.0)]
    C, Zc = _full_chunk(keep)
    cases.append(("full chunk", type(C)(C.data.to(bf), C.indices, C.indptr,
                                        C.n_cols), Zc.to(bf), RCV1_BANDWIDTH))
    for label, Xs, Zl, h in cases:
        for acc in (torch.float32, torch.float64):
            prep = prepare_landmarks(Zl, acc)
            for kind, kw in dict(kinds, rbf=dict(bandwidth=h)).items():
                got = sparse_cross(Xs.data, Xs.indices, Xs.indptr, Zl,
                                   kind=kind, acc_dtype=acc, prepared=prep,
                                   **kw)
                check(got.dtype == bf, f"k3 bf16 returned {got.dtype}")
                want = ref.sparse_kernel_block_ref(
                    Xs.data, Xs.indices, Xs.indptr, Zl, kind=kind,
                    acc_dtype=acc, **kw)
                err, share = _bf16_share(got, want, BF16_STEP,
                                         K3_TOL["float32"])
                note(f"K3.{kind}.acc_{str(acc)[6:]}", err, share,
                     f"{label} {tuple(got.shape)}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return shares


def _bf16_parity(tag: str, hop, plain, predict) -> dict:
    """hopper against torch on the card, the same draws: scores by max
    relative error, β by ‖Δβ‖/‖β‖, predictions by max |Δ| over max |y|."""
    import torch
    y_h, y_t = predict(hop), predict(plain)
    s_h, s_t = hop.scores().double(), plain.scores().double()
    b_h, b_t = hop.state().beta.double(), plain.state().beta.double()
    torch.cuda.synchronize()
    errs = {"scores": float(((s_h - s_t).abs() / s_t.abs()).max()),
            "beta": float(torch.linalg.norm(b_h - b_t)
                          / torch.linalg.norm(b_t)),
            "predictions": float((y_h.double() - y_t.double()).abs().max()
                                 / y_t.double().abs().max())}
    for key, err in errs.items():
        log(f"[bf16] {tag} parity hopper vs {plain.config.backend} at "
            f"n={N_PARITY}: {key} "
            f"{err:.3e} (tolerance {BF16_PARITY_TOL[tag][key]:g})")
    for key, err in errs.items():
        check(err <= BF16_PARITY_TOL[tag][key],
              f"bf16 {tag} parity {key}: {err:.3e} > "
              f"{BF16_PARITY_TOL[tag][key]:g}")
    return errs


def _k3_plain_backend() -> str:
    """The name of a backend, registered once, that is ``torch`` except
    for CSR blocks, which take K3's plain version on the card
    (``ref.sparse_kernel_block_ref``): the function of the reference's
    ``sparse_kernel_block``, and so of its ``pallas`` backend, which rounds
    the cross product to the block dtype before the epilogue. ``torch``
    follows the reference's ``xla`` backend there, which rounds only the
    block; in bf16 the two routes part (``tools/bf16_parity_probe.py``), so
    hopper's CSR path is held to this one."""
    import dataclasses
    import torch
    from repro_torch.core import backends as tb
    from repro_torch.data import CsrMatrix
    from repro_torch.kernels import ref
    name = "k3_plain"
    if name in tb.BACKENDS:
        return name

    @tb.BACKENDS.register(name)
    @dataclasses.dataclass(frozen=True)
    class K3PlainOps(tb.TorchOps):
        def cross(self, X_test, Z, *, prepared=None):
            X_test, Z = self._cast_data(X_test, Z)
            if not isinstance(X_test, CsrMatrix):
                return self._gram(X_test, Z)
            out = torch.promote_types(X_test.dtype, Z.dtype)
            acc = self._accum(out)
            return ref.sparse_kernel_block_ref(
                X_test.data, X_test.indices, X_test.indptr, Z, kind="rbf",
                bandwidth=self.kernel.bandwidth,
                acc_dtype=out if acc is None else acc)

    K3PlainOps.name = name
    return name


def phase_bf16(res: dict, keep: dict) -> None:
    """The bf16 KRR paths at full width, each with its launch counts
    zeroed before and read after: (a) the quantized server (a float32 fit
    of the MSD rows served with Precision(serve_dtype="bf16")) through
    predict_batched(256), AsyncServeEngine over a ModelSlot and
    KRRServeEngine; (b) a fit from bf16 storage of the MSD rows; (c) a fit
    of the RCV1 rows in bf16 CSR chunks. Each is held hopper against torch
    on the card at n = 20,000 with the same draws ((c) against torch with
    K3's plain version for the CSR blocks, ``_k3_plain_backend``); the
    three bf16 kernel instances are first held against their plain
    versions."""
    import numpy as np
    import torch
    from repro_torch.api import (Precision, RBFKernel, SketchConfig,
                                 SketchedKRR)
    from repro_torch.core.leverage import draw_landmarks
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime import KRRRequest, KRRServeEngine
    from repro_torch.serve import AsyncServeEngine, BatchPolicy
    out: dict = {}
    res["bf16"] = out
    out["kernel_shares"] = _bf16_kernel_checks(res, keep)
    Xtr, ytr, Xte, fte = _msd(keep)
    f = torch.as_tensor(fte, device="cuda")
    var_f = float(torch.var(f))

    # (a) the quantized server: the main path's float32 model, served in
    # bf16 blocks with the contraction in float32
    rls, f32_mse = _msd_rls_fast(keep)
    qcfg = SketchConfig(RBFKernel(BANDWIDTH), p=P, lam=LAM,
                        precision=Precision(serve_dtype="bf16"))
    quant = SketchedKRR(qcfg).import_serving_state(rls.export_serving_state())
    quant.predict_batched(Xte[:PREDICT_BATCH], PREDICT_BATCH)   # warm-up
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    yq = quant.predict_batched(Xte, PREDICT_BATCH)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    counts = kops.launch_counts()
    batches = -(-N_TEST // PREDICT_BATCH)
    mse_q = _mse(yq, fte)
    st = quant.export_serving_state()
    Xte_c = torch.as_tensor(Xte, device="cuda")
    # one bf16 step of each term of an answer's contraction
    scale = rls.ops().matvec(Xte_c, st.landmarks, st.beta.abs())
    log(f"[bf16] (a) quantized predict_batched({PREDICT_BATCH}) over "
        f"{N_TEST} rows: {pred_s:.3f} s = {N_TEST / pred_s:.0f} "
        f"predictions/s, launches {counts}; test MSE vs f* {mse_q:.6f}, "
        f"the float32 server's {f32_mse:.6f}, var(f*) {var_f:.4f}")
    check(yq.dtype == torch.float32 and yq.shape == (N_TEST,),
          f"(a) predictions {yq.dtype} {tuple(yq.shape)}")
    check(bool(torch.isfinite(yq).all()), "(a) non-finite predictions")
    check(counts["kernel_block"] == batches,
          f"(a) K1 launched {counts['kernel_block']} times for {batches} "
          "batches")
    check(mse_q < var_f, f"(a) test MSE {mse_q:.4f} >= var(f*)")
    # the torch backend on the card serves the same β and landmarks
    plain_q = SketchedKRR(qcfg.replace(backend="torch")).import_serving_state(
        st)
    kops.reset_launch_counts()
    yq_t = plain_q.predict_batched(Xte, PREDICT_BATCH)
    check(sum(kops.launch_counts().values()) == 0,
          f"(a) the torch backend launched {kops.launch_counts()}")
    mse_qt = _mse(yq_t, fte)
    gaps = {"hopper": abs(mse_q - f32_mse) / f32_mse,
            "torch": abs(mse_qt - f32_mse) / f32_mse}
    # the ceiling: one bf16 step of each term of an answer's contraction
    share_a = float(torch.max((yq - yq_t).abs().double()
                              / (BF16_STEP * scale.double() + 1e-6)))
    log(f"[bf16] (a) quantized test MSE: hopper {mse_q:.6f}, torch "
        f"{mse_qt:.6f}, relative gap to the float32 server's {gaps} "
        f"(bound {QUANT_MSE_GAP:g}); hopper vs torch over the {N_TEST} test "
        f"rows: max |Δ| {float((yq - yq_t).abs().max()):.3e}, "
        f"{share_a:.3f} of the ceiling 2^-7 sum_j |k_j beta_j| + 1e-6")
    for route, gap in gaps.items():
        check(gap <= QUANT_MSE_GAP,
              f"(a) {route}: quantized MSE {gap:.3e} from the float32 "
              "server's")
    check(share_a <= 1.0, f"(a) parity {share_a:.3f} of its ceiling")
    out["a"] = dict(predict_s=pred_s, predictions_per_s=N_TEST / pred_s,
                    launches=counts, test_mse=mse_q, torch_test_mse=mse_qt,
                    f32_test_mse=f32_mse, mse_gaps=gaps, var_f_star=var_f,
                    parity_share=share_a)
    # the async serve plane over a ModelSlot of the quantized model
    policy = BatchPolicy(max_batch=PREDICT_BATCH, max_wait_ms=2.0)

    def serve_once():
        eng = AsyncServeEngine({"q": quant}, policy=policy)
        with eng:
            subs, submit_s = _serve_clients(eng, Xte, np.arange(N_TEST),
                                            ("q",))
            got = [(i, fut.result(60)) for i, _, fut in subs]
        return eng, got, submit_s

    serve_once()                         # warm-up: each bucket once
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    eng, got, submit_s = serve_once()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    stats = eng.stats()
    yq_h = yq.cpu().numpy()
    sc = scale.cpu().numpy()
    worst_abs = max(abs(r.y_hat - float(yq_h[i])) for i, r in got)
    worst = max(abs(r.y_hat - float(yq_h[i])) / float(sc[i]) for i, r in got)
    log(f"[bf16] (a) AsyncServeEngine over a ModelSlot of the quantized "
        f"model, {N_TEST} single-row requests from 4 threads: "
        f"{N_TEST / wall:.0f} requests/s, p50 {stats.p50():.2f} ms, p99 "
        f"{stats.p99():.2f} ms, {stats.batches} batches, K1 launches "
        f"{counts['kernel_block']}; max |answer - predict_batched| "
        f"{worst_abs:.3e} = {worst:.3e} of sum_j |k_j beta_j| (tolerance "
        f"{QUANT_ANSWER_TOL:g})")
    check(stats.served == N_TEST and len(got) == N_TEST,
          f"(a) served {stats.served} of {N_TEST}")
    check(counts["kernel_block"] == stats.batches,
          f"(a) K1 launched {counts['kernel_block']} times for "
          f"{stats.batches} batches")
    check(worst <= QUANT_ANSWER_TOL, f"(a) an answer is {worst:.3e} of "
          "sum_j |k_j beta_j| from predict_batched")
    out["a"].update(requests_per_s=N_TEST / wall, p50_ms=stats.p50(),
                    p99_ms=stats.p99(), batches=stats.batches,
                    serve_launches=counts, answer_max_abs_dev=worst_abs,
                    answer_max_rel_dev=worst)
    del got
    sync = KRRServeEngine(quant, batch_size=PREDICT_BATCH)
    for i in range(N_TEST):
        sync.submit(KRRRequest(i, Xte[i]))
    done = sync.run(max_steps=N_TEST)
    diff = max(abs(r.y_hat - float(yq_h[r.uid])) for r in done)
    log(f"[bf16] (a) KRRServeEngine(batch_size={PREDICT_BATCH}) serving "
        f"{sync.serve_dtype}: {len(done)} answers, max |answer - "
        f"predict_batched({PREDICT_BATCH})| {diff:.3e}")
    check(len(done) == N_TEST and diff == 0.0 and
          sync.serve_dtype == "bfloat16",
          f"(a) KRRServeEngine: {len(done)} answers, deviation {diff:.3e}")
    del quant, plain_q, sync, done
    torch.cuda.empty_cache()

    # (b) a fit from bf16 storage of the MSD rows, float64 solves (R5)
    bcfg = SketchConfig(RBFKernel(BANDWIDTH), p=P, lam=LAM,
                        precision=Precision(**BF16_PRECISION))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    model = SketchedKRR(bcfg).fit(Xtr, ytr)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = kops.launch_counts()
    t0 = time.perf_counter()
    yb = model.predict_batched(Xte, PREDICT_BATCH)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - held
    scores = model.scores()
    mse_b = _mse(yb, fte)
    log(f"[bf16] (b) bf16 storage fit {fit_s:.3f} s (launches {fit_counts}),"
        f" predict_batched {pred_s:.3f} s, launches after {counts}; peak "
        f"{peak / 1e9:.2f} GB above {held / 1e9:.2f} GB held; test MSE vs "
        f"f* {mse_b:.6f} (float32 cell {f32_mse:.6f}, var(f*) "
        f"{var_f:.4f}); scores {scores.dtype} in "
        f"[{float(scores.min()):.4g}, {float(scores.max()):.4g}], β "
        f"{model.state().beta.dtype}")
    check(scores.dtype == torch.bfloat16 and bool(torch.isfinite(
        scores).all()) and float(scores.min()) >= 0.0
        and float(scores.max()) <= 1.05, "(b) scores not in [0, 1.05]")
    check(bool(torch.isfinite(yb).all()), "(b) non-finite predictions")
    check(fit_counts["kernel_block"] >= 2 and fit_counts["rls_scores"] >= 1,
          f"(b) fit launched {fit_counts}")
    check(counts["kernel_block"] - fit_counts["kernel_block"] == batches,
          f"(b) predict launched {counts}")
    check(mse_b < var_f, f"(b) test MSE {mse_b:.4f} >= var(f*)")
    out["b"] = dict(fit_s=fit_s, predict_s=pred_s, peak_bytes=peak,
                    held_bytes=held, test_mse=mse_b, f32_test_mse=f32_mse,
                    var_f_star=var_f, fit_launches=fit_counts,
                    launches=counts,
                    scores_range=[float(scores.min()), float(scores.max())])
    del scores, yb
    prof = _profile(lambda: (model.fit(Xtr, ytr),
                             model.predict_batched(Xte, PREDICT_BATCH)))
    _profile_line("(b) bf16 storage fit + predict", prof, fit_s + pred_s,
                  "bf16")
    out["b"]["profile"] = prof
    del model
    torch.cuda.empty_cache()
    idx = draw_landmarks(torch.Generator().manual_seed(3),
                         torch.full((N_PARITY,), 1.0 / N_PARITY), P)
    sub = (Xtr[:N_PARITY], ytr[:N_PARITY])
    hop = SketchedKRR(bcfg.replace(backend="hopper")).fit(
        *sub, score_landmarks=idx)
    plain = SketchedKRR(bcfg.replace(backend="torch")).fit(
        *sub, score_landmarks=idx, sample=hop.sample())
    out["b"]["parity"] = _bf16_parity(
        "b", hop, plain, lambda m: m.predict(Xte[:N_PARITY_TEST]))
    del hop, plain
    torch.cuda.empty_cache()

    # (c) the RCV1 rows in bf16 CSR chunks, accumulated in float64 as the
    # sparse cell is (BF16_SPARSE_PRECISION: the bf16 rule's float32 fails
    # at this n); then, at the parity size, hopper against K3's plain
    # version under the cell's policy and under the bf16 rule (float32
    # accumulation), which runs K3's and K1's bf16 / float32 instances on
    # the path
    rc = _rcv1(keep)
    ccfg = SketchConfig(RBFKernel(RCV1_BANDWIDTH), p=P, lam=LAM,
                        chunk_rows=CHUNK_ROWS,
                        precision=Precision(**BF16_SPARSE_PRECISION))
    f_c = torch.as_tensor(rc["f_test"], device="cuda")
    var_c = float(torch.var(f_c))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    model = SketchedKRR(ccfg).fit(rc["train"], rc["y"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = kops.launch_counts()
    t0 = time.perf_counter()
    yc = model.predict(rc["test"])
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - held
    mse_c = _mse(yc, rc["f_test"])
    f32_c = res.get("sparse", {}).get("test_mse")
    log(f"[bf16] (c) bf16 CSR chunk fit {fit_s:.3f} s (launches "
        f"{fit_counts}), predict {pred_s:.3f} s = {RCV1_TEST / pred_s:.0f} "
        f"predictions/s, launches after {counts}; peak {peak / 1e9:.2f} GB "
        f"above {held / 1e9:.2f} GB held; test MSE vs f* {mse_c:.6f} (the "
        f"sparse cell's {'not run' if f32_c is None else f'{f32_c:.6f}'}, "
        f"var(f*) {var_c:.4f})")
    check(bool(torch.isfinite(yc).all()), "(c) non-finite predictions")
    check(bool(torch.isfinite(model.scores().float()).all()),
          "(c) non-finite scores")
    check(fit_counts["sparse_cross"] >= 18 and fit_counts["kernel_block"]
          >= 2 and fit_counts["rls_scores"] == 0,
          f"(c) fit launched {fit_counts}")
    check(counts["sparse_cross"] > fit_counts["sparse_cross"],
          f"(c) predict launched {counts}")
    check(mse_c < var_c, f"(c) test MSE {mse_c:.4f} >= var(f*)")
    out["c"] = dict(fit_s=fit_s, predict_s=pred_s, peak_bytes=peak,
                    held_bytes=held, test_mse=mse_c, f32_test_mse=f32_c,
                    var_f_star=var_c, fit_launches=fit_counts,
                    launches=counts)
    keep["bf16_sparse_Z"] = model.state().landmarks
    del yc
    prof = _profile(lambda: (model.fit(rc["train"], rc["y"]),
                             model.predict(rc["test"])))
    _profile_line("(c) bf16 CSR fit + predict", prof, fit_s + pred_s,
                  "bf16")
    out["c"]["profile"] = prof
    del model
    torch.cuda.empty_cache()
    sub = _csr_rows(rc["train"], 0, N_PARITY)
    test = _csr_rows(rc["test"], 0, N_PARITY_TEST)
    f_sub = rc["f_test"][:N_PARITY_TEST]
    for tag, policy in (("c", BF16_SPARSE_PRECISION),
                        ("c_f32acc", BF16_PRECISION)):
        pcfg = ccfg.replace(chunk_rows=PARITY_CHUNK,
                            precision=Precision(**policy))
        kops.reset_launch_counts()
        hop = SketchedKRR(pcfg.replace(backend="hopper")).fit(
            sub, rc["y"][:N_PARITY], score_landmarks=idx)
        y_h = hop.predict(test)
        torch.cuda.synchronize()
        hop_counts = kops.launch_counts()
        plain = SketchedKRR(pcfg.replace(backend=_k3_plain_backend())).fit(
            sub, rc["y"][:N_PARITY], score_landmarks=idx,
            sample=hop.sample())
        errs = _bf16_parity(tag, hop, plain, lambda m: m.predict(test))
        mse_h = _mse(y_h, f_sub)
        log(f"[bf16] {tag} at n={N_PARITY} ({policy}): hopper launches "
            f"{hop_counts}, test MSE {mse_h:.6f}")
        check(hop_counts["sparse_cross"] > 0 and
              hop_counts["kernel_block"] > 0, f"{tag}: {hop_counts}")
        out[tag] = dict(out.get(tag, {}), parity=errs,
                        parity_launches=hop_counts, parity_test_mse=mse_h)
        del hop, plain, y_h
        torch.cuda.empty_cache()

def _ptxas_of(res: dict, lib: str, key: str) -> dict | None:
    """The largest registers, spill stores and stack frame that ptxas -v
    reported over the variants of one kernel (``key`` in its entry name)
    in ``lib``'s build log; None where the build did not run here."""
    import re
    lines = [ln for ln in res.get("ptxas", {}).get(lib, []) if key in ln]
    if not lines:
        return None

    def most(pattern):
        vals = [int(m.group(1)) for ln in lines
                for m in [re.search(pattern, ln)] if m]
        return max(vals) if vals else None

    return dict(registers=most(r"Used (\d+) registers"),
                spill_store_bytes=most(r"(\d+) bytes spill stores"),
                stack_bytes=most(r"(\d+) bytes stack frame"))


def _bf16_k3_row(res: dict, Xc, Zw, acc, n_launch) -> dict:
    """K3's bf16 row at one full chunk of the sparse cell (bf16 values)
    against bf16 landmark rows, accumulated in ``acc``: the kernel, its
    plain version, the linear kind, and torch.sparse.mm on bf16 CSR where
    CUDA offers it. Bound at the peak of the CUDA cores' fma in ``acc``,
    over the work that meets a non-zero of Z (the dense count beside)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.sparse_block import (prepare_landmarks,
                                                  sparse_cross)
    tag = f"bf16/{str(acc)[6:]}"
    rows_n, p3, d3 = Xc.shape[0], Zw.shape[0], RCV1_DIM
    nnz = int(Xc.indptr[-1])
    args = (Xc.data, Xc.indices, Xc.indptr, Zw)
    kw = dict(kind="rbf", bandwidth=RCV1_BANDWIDTH)
    prep = prepare_landmarks(Zw, acc)
    err, share = _bf16_share(
        sparse_cross(*args, acc_dtype=acc, prepared=prep, **kw),
        ref.sparse_kernel_block_ref(*args, acc_dtype=acc, **kw),
        BF16_STEP, K3_TOL["float32"])
    ms = cuda_ms(lambda: sparse_cross(*args, acc_dtype=acc, prepared=prep,
                                      **kw), reps=10)
    plain = cuda_ms(lambda: ref.sparse_kernel_block_ref(
        *args, acc_dtype=acc, **kw), reps=3)
    lin = cuda_ms(lambda: sparse_cross(*args, kind="linear", acc_dtype=acc,
                                       prepared=prep), reps=10)
    try:
        A = torch.sparse_csr_tensor(Xc.indptr, Xc.indices[:nnz],
                                    Xc.data[:nnz], size=(rows_n, d3),
                                    check_invariants=False)
        Zt = Zw.T.contiguous()
        lib = cuda_ms(lambda: torch.sparse.mm(A, Zt), reps=10)
        lib_note = "torch.sparse.mm on bf16 CSR (linear kind)"
    except (RuntimeError, NotImplementedError) as exc:
        lib = None
        lib_note = (f"torch.sparse.mm does not take bf16 CSR here: "
                    f"{str(exc).splitlines()[0][:120]}")
    work3, _ = _k3_work(Xc, Zw)
    prep_bytes = sum(t.numel() * t.element_size() for t in (
        prep.zz, prep.hot_slot, prep.hot, prep.colptr, prep.ent_j,
        prep.ent_z))
    nbytes = 6 * nnz + 4 * (rows_n + 1) + 2 * rows_n * p3
    peak = "float64" if acc == torch.float64 else "float32"
    b3, by3 = _bound_ms(2 * work3 + 5 * rows_n * p3, nbytes + prep_bytes,
                        peak)
    dense3, dby3 = _bound_ms(2 * nnz * p3 + 5 * rows_n * p3,
                             nbytes + 2 * d3 * p3, peak)
    log(f"[summary] K3 {tag} rbf full chunk (rows,p,d)=({rows_n},{p3},{d3}), "
        f"{nnz} values: kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
        f"{b3:.3f} ms ({by3}; dense count {dense3:.3f} ms, {dby3}); linear "
        f"kind {lin:.3f} ms; library: {lib_note} "
        f"{'' if lib is None else f'{lib:.3f} ms'}; max|Δ| {err:.3e} "
        f"({share:.3f} of the tolerance), launches on its path {n_launch}")
    check(share <= 1.0, f"K3 {tag}: {share:.3f} of the tolerance")
    return dict(name="sparse_cross", shape=f"{tag} full chunk",
                dtype="bfloat16", acc=str(acc)[6:], route="cuda",
                ptxas=_ptxas_of(res, "sparse_cross",
                                "sparse_cross_kernelI13__nv_bfloat16"
                                + ("d" if acc == torch.float64 else "f")),
                source="src/repro_torch/kernels/csrc/sparse_cross.cu",
                replaces="src/repro/kernels/sparse_block.py:149",
                launches=n_launch, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b3, bound_by=by3, library_ms=lib,
                dense_bound_ms=dense3, dense_bound_by=dby3,
                tolerance_share=share, library_fn=lib_note,
                library_kernel_ms=lin)


def _bf16_w_row(res: dict, Zw, acc, n_launch) -> dict:
    """K1's bf16 row at the sparse cell's W = k(Z, Z) over bf16 landmark
    rows, accumulated in ``acc`` (float32: the bf16 tensor cores; float64:
    the FP64 ones), bound over the work this Z needs at that peak."""
    import torch
    from repro_torch.kernels.rbf_block import kernel_block
    tag = f"bf16/{str(acc)[6:]}"
    peak, warp = (("float64", (32, 32, 8)) if acc == torch.float64
                  else ("bfloat16", (64, 32, 16)))
    bw_, byw, work, mma = _k1_w_bound(Zw, peak, warp)
    kw = dict(kind="rbf", bandwidth=RCV1_BANDWIDTH, acc_dtype=acc)
    err, share = _bf16_share(kernel_block(Zw, Zw, **kw),
                             _bf16_k1_plain(Zw, Zw, "rbf", acc,
                                            bandwidth=RCV1_BANDWIDTH),
                             BF16_STEP, K1_TOL["float32"])
    ms = cuda_ms(lambda: kernel_block(Zw, Zw, **kw), reps=10)
    plain = cuda_ms(lambda: _bf16_k1_plain(Zw, Zw, "rbf", acc,
                                           bandwidth=RCV1_BANDWIDTH), reps=3)
    lin = cuda_ms(lambda: kernel_block(Zw, Zw, kind="linear", acc_dtype=acc),
                  reps=10)
    mm = cuda_ms(lambda: torch.matmul(Zw, Zw.T), reps=10)
    log(f"[summary] K1 {tag} rbf W (n,p,d)=({Zw.shape[0]},{Zw.shape[0]},"
        f"{Zw.shape[1]}): kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bw_:.4f} ms ({byw}; the work Z needs is {100 * work:.3f} % of the "
        f"dense products, the warp steps that run {100 * mma:.2f} %); linear "
        f"kind {lin:.4f} ms, torch.matmul on the bf16 operands {mm:.4f} ms; "
        f"max|Δ| {err:.3e} ({share:.3f} of the tolerance), launches on its "
        f"path {n_launch}")
    check(share <= 1.0, f"K1 {tag} W: {share:.3f} of the tolerance")
    return _k1_row(f"{tag} W", n_launch, err, ms, plain, bw_, byw, mm,
                   dtype="bfloat16", acc=str(acc)[6:], tolerance_share=share,
                   ptxas=_ptxas_of(res, "kernel_block",
                                   "mma6kernelI13__nv_bfloat16"
                                   if acc == torch.float64 else "hmma"),
                   linear_ms=lin, work_share=work, mma_share=mma,
                   library_fn="torch.matmul on the bf16 operands against "
                              "the linear kind")


def _summary_bf16(res: dict, keep: dict) -> list[dict]:
    """The bf16 instances' rows at phase bf16's shapes: K1 at the fit's
    block (463,715, 2048, 90) and a predict batch (256, 2048, 90), with the
    linear kind beside torch.matmul on the bf16 operands (cuBLAS); K2 at
    (463,715, 2048) beside the einsum on upcast B; K1 at the sparse cell's
    W = k(Z, Z) over bf16 landmark rows and K3 at one full chunk of it, in
    float64 accumulation (the cell's, at full width) and float32 (the bf16
    rule, on the parity path), K3 beside torch.sparse.mm in bf16 where CUDA
    offers it. Bounds at the peak of the arithmetic that runs: the bf16 or
    FP64 tensor cores for K1, TF32 for K2's two products, the CUDA cores'
    fma for K3."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rbf_block import kernel_block
    from repro_torch.kernels.rls_scores import rls_scores_fused
    bf, f32 = torch.bfloat16, torch.float32
    b16 = res.get("bf16", {})

    def launches(path, kernel, key="fit_launches"):
        return b16.get(path, {}).get(key, {}).get(kernel)

    for name in ("kernel_block", "rls_scores", "sparse_cross"):
        for line in res.get("ptxas", {}).get(name, []):
            if "bfloat16" in line or "hmma" in line:
                log(f"[summary] ptxas bf16 {name}: {line}")
    rows = []
    Xf = torch.as_tensor(_msd(keep)[0], device="cuda")
    n, d = Xf.shape
    X = Xf.to(bf)
    del Xf
    Z = X[torch.randperm(n, generator=torch.Generator().manual_seed(6))[:P]
          .cuda()].contiguous()

    def k1_row(label, Xs, n_launch, reps):
        rows_n = Xs.shape[0]
        kw = dict(kind="rbf", bandwidth=BANDWIDTH)
        err, share = _bf16_share(kernel_block(Xs, Z, **kw),
                                 _bf16_k1_plain(Xs, Z, "rbf", f32,
                                                bandwidth=BANDWIDTH),
                                 BF16_STEP, K1_TOL["float32"])
        ms = cuda_ms(lambda: kernel_block(Xs, Z, **kw), reps=reps)
        plain = cuda_ms(lambda: _bf16_k1_plain(Xs, Z, "rbf", f32,
                                               bandwidth=BANDWIDTH),
                        reps=reps)
        lin = cuda_ms(lambda: kernel_block(Xs, Z, kind="linear"), reps=reps)
        mm = cuda_ms(lambda: torch.matmul(Xs, Z.T), reps=reps)
        ops = 2 * rows_n * P * d + 2 * (rows_n + P) * d + 5 * rows_n * P
        b, by = _bound_ms(ops, 2 * (rows_n * d + P * d + rows_n * P),
                          "bfloat16")
        log(f"[summary] K1 bf16/float32 rbf {label} (n,p,d)=({rows_n},{P},"
            f"{d}) (bf16 tensor cores): kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b:.4f} ms ({by}); linear kind "
            f"{lin:.4f} ms, torch.matmul on the bf16 operands {mm:.4f} ms; "
            f"max|Δ| {err:.3e} ({share:.3f} of the tolerance), launches on "
            f"its path {n_launch}")
        check(share <= 1.0, f"K1 bf16 {label}: {share:.3f} of tolerance")
        return _k1_row(f"bf16/float32 {label}", n_launch, err, ms, plain, b,
                       by, mm, dtype="bfloat16", acc="float32",
                       tolerance_share=share, linear_ms=lin,
                       ptxas=_ptxas_of(res, "kernel_block", "hmma"),
                       library_fn="torch.matmul on the bf16 operands "
                                  "against the linear kind")

    rows.append(k1_row("fit", X, launches("b", "kernel_block"), 10))
    rows.append(k1_row("predict", X[:PREDICT_BATCH],
                       launches("a", "kernel_block", "launches"), 100))
    del X, Z
    torch.cuda.empty_cache()

    # K2: bf16 B (the score pass's), M in float32
    B, M = _scores_problem(N_TRAIN, P, bf,
                           torch.Generator(device="cuda").manual_seed(4))
    Mf = M.float()
    del M
    Bf = B.float()
    err, share = _bf16_share(rls_scores_fused(B, Mf),
                             ref.rls_scores_ref(Bf, Mf).to(bf),
                             BF16_STEP + K2_RTOL["float32"], 1e-6)
    ms = cuda_ms(lambda: rls_scores_fused(B, Mf), reps=3)
    plain = cuda_ms(lambda: ref.rls_scores_ref(B.float(), Mf).to(bf), reps=3)
    lib = cuda_ms(lambda: torch.einsum("ij,jk,ik->i", Bf, Mf, Bf), reps=3)
    n2, p2 = B.shape
    nbytes = 2 * n2 * p2 + 4 * p2 * p2 + 2 * n2
    b2, by2 = _bound_ms(2 * 2 * n2 * p2 * p2 + 2 * n2 * p2, nbytes, "tf32")
    ieee2, _ = _bound_ms(2 * n2 * p2 * p2 + 2 * n2 * p2, nbytes, "float32")
    log(f"[summary] K2 bf16/float32 (n,p)=({n2},{p2}) (2xTF32): kernel "
        f"{ms:.3f} ms, plain {plain:.3f} ms, einsum on upcast B {lib:.3f} ms, "
        f"bound {b2:.3f} ms ({by2}; IEEE float32 {ieee2:.3f} ms), max|Δ| "
        f"{err:.3e} ({share:.3f} of the tolerance), launches on its path "
        f"{launches('b', 'rls_scores')}")
    check(share <= 1.0, f"K2 bf16: {share:.3f} of the tolerance")
    rows.append(dict(name="rls_scores", shape="bf16/float32 fit",
                     dtype="bfloat16", acc="float32", route="cuda",
                     source="src/repro_torch/kernels/csrc/rls_scores.cu",
                     replaces="src/repro/kernels/rls_scores.py:37",
                     launches=launches("b", "rls_scores"), max_abs_err=err,
                     ms=ms, plain_ms=plain, bound_ms=b2, bound_by=by2,
                     library_ms=lib, ieee_f32_bound_ms=ieee2,
                     tolerance_share=share,
                     ptxas=_ptxas_of(res, "rls_scores",
                                     "rls_scores_tf32x3I13__nv_bfloat16"),
                     library_fn="einsum on float32 copies of B"))
    del B, Bf, Mf
    torch.cuda.empty_cache()

    # W = k(Z, Z) and one chunk of the sparse cell: float64 accumulation at
    # full width (the cell's policy), float32 on the parity path
    C, Zs = _full_chunk(keep)
    Zw = keep.get("bf16_sparse_Z", Zs).to(bf).contiguous()
    Xc = type(C)(C.data.to(bf), C.indices, C.indptr, C.n_cols)
    for acc, path, key in ((torch.float64, "c", "fit_launches"),
                           (f32, "c_f32acc", "parity_launches")):
        rows.append(_bf16_w_row(res, Zw, acc,
                                launches(path, "kernel_block", key)))
        rows.append(_bf16_k3_row(res, Xc, Zw, acc, launches(
            path, "sparse_cross",
            "launches" if path == "c" else "parity_launches")))
    return rows

def _summary_slice7(res: dict, keep: dict) -> list[dict]:
    """The rows of the shapes phase samplers and phase serve run: K1's
    FP64-tensor-core build (float32 data, float64 accumulation) at a bless
    stage (463,715, 2048, 90) beside torch.matmul on float64 copies; K1 at
    a dnc partition (13,249, 13,249, 90); K1 at each serve bucket of (i);
    and K2's float64-accumulating build on float32 B at (463,715, 2048)
    beside the float64 einsum."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rbf_block import kernel_block
    from repro_torch.kernels.rls_scores import rls_scores_fused
    X = torch.as_tensor(_msd(keep)[0], device="cuda")
    n, d = X.shape
    Z = X[torch.randperm(n, generator=torch.Generator().manual_seed(6))[:P]
          .cuda()].contiguous()
    smp = res.get("samplers", {})
    rows = []
    acc = torch.float64
    X64, Z64 = X.double(), Z.double()
    C = kernel_block(X, Z, kind="rbf", bandwidth=BANDWIDTH, acc_dtype=acc)
    err = float((C - ref.rbf_block_ref(X64, Z64, BANDWIDTH).float())
                .abs().max())
    del C
    ms = cuda_ms(lambda: kernel_block(X, Z, kind="rbf", bandwidth=BANDWIDTH,
                                      acc_dtype=acc), reps=5)
    plain = cuda_ms(lambda: ref.rbf_block_ref(X64, Z64, BANDWIDTH).float(),
                    reps=2)
    lib = cuda_ms(lambda: torch.matmul(X64, Z64.T), reps=3)
    bound, by = _k1_bound(n, P, d, "float64")
    launches = (smp["a"]["fit_launches"]["kernel_block"] - 1
                if "a" in smp else None)
    log(f"[summary] K1 rbf bless stage (n,p,d)=({n},{P},{d}) f32 data / f64 "
        f"accumulation (FP64 tensor cores): kernel {ms:.3f} ms, plain "
        f"{plain:.3f} ms, torch.matmul on float64 copies {lib:.3f} ms, bound "
        f"{bound:.3f} ms ({by}), max|Δ| {err:.3e}, launches on the bless "
        f"path {launches}")
    check(err <= K1_TOL["float32"], f"K1 bless stage: {err:.3e}")
    rows.append(_k1_row("bless stage", launches, err, ms, plain, bound, by,
                        lib, library_fn="torch.matmul on float64 copies"))
    del X64, Z64
    torch.cuda.empty_cache()
    size = N_TRAIN // DNC_PARTITIONS
    rows.append(_k1_shape_row(
        "dnc partition", X[:size], X[:size].contiguous(),
        smp.get("d", {}).get("fit_launches", {}).get("kernel_block"), 10))
    for bucket, count in res.get("serve", {}).get("i", {}).get(
            "buckets", {}).items():
        rows.append(_k1_shape_row(f"serve bucket {bucket}", X[:bucket], Z,
                                  count, 100))
    # K2's float64-accumulating build on float32 B (the bless stages')
    B, M = _scores_problem(n, P, torch.float32,
                           torch.Generator(device="cuda").manual_seed(4))
    s = rls_scores_fused(B, M, acc_dtype=acc)
    B64 = B.double()
    want = ref.rls_scores_ref(B64, M)
    rel = float(((s.double() - want).abs() / want.abs()).max())
    err2 = float((s.double() - want).abs().max())
    del want
    ms2 = cuda_ms(lambda: rls_scores_fused(B, M, acc_dtype=acc), reps=3)
    plain2 = cuda_ms(lambda: ref.rls_scores_ref(B64, M).float(), reps=3)
    lib2 = cuda_ms(lambda: torch.einsum("ij,jk,ik->i", B64, M, B64), reps=3)
    ops2 = 2 * n * P * P + 2 * n * P
    b2, by2 = _bound_ms(ops2, 4 * (n * P + n) + 8 * P * P, "float64")
    simt2 = ops2 / (PEAK_OPS["float64"] / 2) * 1e3
    launches2 = smp["a"]["fit_launches"]["rls_scores"] if "a" in smp else None
    log(f"[summary] K2 (n,p)=({n},{P}) f32 data / f64 accumulation (SIMT "
        f"fma): kernel {ms2:.3f} ms, plain {plain2:.3f} ms, float64 einsum "
        f"{lib2:.3f} ms, bound {b2:.3f} ms ({by2}, the FP64 peak; "
        f"{simt2:.3f} ms at the CUDA cores' half of it), max rel Δ "
        f"{rel:.3e} (rtol {K2_RTOL['float32']:g}), launches on the bless "
        f"path {launches2}")
    check(rel <= K2_RTOL["float32"], f"K2 f32/f64 at main shape: {rel:.3e}")
    del B, B64, M
    torch.cuda.empty_cache()
    rows.append(dict(name="rls_scores", shape="bless stage, f32/f64",
                     route="cuda",
                     source="src/repro_torch/kernels/csrc/rls_scores.cu",
                     replaces="src/repro/kernels/rls_scores.py:37",
                     launches=launches2, max_abs_err=err2, ms=ms2,
                     plain_ms=plain2, bound_ms=b2, bound_by=by2,
                     library_ms=lib2, simt_f64_bound_ms=simt2,
                     library_fn="einsum on float64 copies"))
    return rows


def _lm_config():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM_ARCH), use_pallas=True,
                               dtype="bfloat16")


def _family_config(arch: str):
    """A family cell's published config as phase families serves it."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), use_pallas=True,
                               dtype="bfloat16")


def _logit_parity(got, want) -> dict:
    """max |Δ| against the largest |logit|, and the share of positions
    whose arg-max agrees; (..., vocab) float32 logits."""
    scale = float(want.abs().max())
    return dict(max_abs=float((got - want).abs().max()), max_logit=scale,
                argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                                   .float().mean()))


def phase_lm(res: dict, keep: dict) -> None:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import (decode_step, forward, init_decode_state,
                                    init_model)
    cfg = _lm_config()
    out = res["lm"] = dict(arch=LM_ARCH, seq=LM_SEQ, dtype=cfg.dtype,
                           n_params=cfg.n_params())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()     # what earlier phases keep
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["param_bytes"] = torch.cuda.memory_allocated() - held
    log(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}), {cfg.n_params() / 1e9:.3f} B parameters: "
        f"{out['param_bytes'] / 1e9:.2f} GB of {cfg.dtype} weights made in "
        f"{out['init_s']:.1f} s")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, LM_SEQ)),
                             dtype=torch.int32, device="cuda")

    # the prefill: a first run (the library loads, cuBLAS picks its
    # kernels), then the measured run with the counts zeroed just before
    t0 = time.perf_counter()
    forward(params, cfg, tokens)
    torch.cuda.synchronize()
    out["first_prefill_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = forward(params, cfg, tokens).logits
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    out.update(prefill_s=wall, tokens_per_s=LM_SEQ / wall, launches=counts,
               peak_bytes=torch.cuda.max_memory_allocated() - base,
               held_bytes=held)
    log(f"[lm] prefill 1 x {LM_SEQ}: {wall:.3f} s = "
        f"{LM_SEQ / wall:.0f} tokens/s (first run {out['first_prefill_s']:.2f}"
        f" s); launches {counts}; peak device memory "
        f"{out['peak_bytes'] / 1e9:.2f} GB above the weights and the "
        f"{held / 1e9:.2f} GB earlier phases hold")
    check(logits.shape == (1, LM_SEQ, cfg.padded_vocab)
          and logits.dtype == torch.float32,
          f"logits {logits.dtype} {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(counts["flash_attention"] == cfg.n_layers,
          f"flash_attention launched {counts['flash_attention']} times in "
          f"the prefill (expected {cfg.n_layers}, one per layer)")
    prof = _profile(lambda: forward(params, cfg, tokens))
    prof["busy_share_of_unprofiled_wall"] = prof["busy_us"] / 1e6 / wall
    out["profile"] = prof
    log(f"[lm] profiled prefill: device busy {prof['busy_us'] / 1e3:.1f} ms "
        f"= {100 * prof['busy_share_of_unprofiled_wall']:.1f} % of the "
        f"unprofiled {1e3 * wall:.0f} ms (profiled wall "
        f"{prof['wall_us'] / 1e3:.0f} ms), {prof['launches']} device "
        f"operations")
    for row in prof["kernels"]:
        log(f"[lm]   {row['device_us'] / 1e3:9.2f} ms  x{row['calls']:<4d} "
            f"{row['name']}")

    # parity: the same prefill through the plain chunked attention
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    t0 = time.perf_counter()
    plain = forward(params, plain_cfg, tokens).logits
    torch.cuda.synchronize()
    out["plain_prefill_s"] = time.perf_counter() - t0
    par = out["parity_plain"] = _logit_parity(logits, plain)
    del plain, logits
    log(f"[lm] prefill through K4 vs the plain chunked attention "
        f"({out['plain_prefill_s']:.2f} s): max|Δ| {par['max_abs']:.4g} "
        f"against a largest |logit| {par['max_logit']:.4g} (tolerance "
        f"{LM_LOGIT_RTOL:g} of it), arg-max agrees at "
        f"{100 * par['argmax_agree']:.2f} % of {LM_SEQ} positions (at least "
        f"{100 * LM_ARGMAX_AGREE:g} %)")
    check(par["max_abs"] <= LM_LOGIT_RTOL * par["max_logit"],
          f"prefill parity: max|Δ| {par['max_abs']:.4g}")
    check(par["argmax_agree"] >= LM_ARGMAX_AGREE,
          f"prefill parity: arg-max agrees at {par['argmax_agree']:.4f}")

    # decode against prefill: LM_DECODE_PROMPT decode steps give the
    # forward's last logits and its greedy token
    prompt = tokens[:, :LM_DECODE_PROMPT]
    full = forward(params, cfg, prompt).logits[:, -1]
    st = init_decode_state(cfg, 1, LM_DECODE_PROMPT, device="cuda")
    for i in range(LM_DECODE_PROMPT):
        lg, st = decode_step(params, cfg, prompt[:, i:i + 1], st)
    dec = out["parity_decode"] = _logit_parity(lg[:, 0], full)
    top2 = torch.topk(full[0], 2).values
    gap = float(top2[0] - top2[1])
    log(f"[lm] decode x{LM_DECODE_PROMPT} vs prefill, last position: max|Δ| "
        f"{dec['max_abs']:.4g} against a largest |logit| "
        f"{dec['max_logit']:.4g} (tolerance {LM_LOGIT_RTOL:g} of it); greedy "
        f"tokens {int(lg[0, 0].argmax())} / {int(full[0].argmax())}, top-2 "
        f"gap {gap:.4g}")
    check(dec["max_abs"] <= LM_LOGIT_RTOL * dec["max_logit"],
          f"decode parity: max|Δ| {dec['max_abs']:.4g}")
    if gap > LM_LOGIT_RTOL * dec["max_logit"]:
        check(dec["argmax_agree"] == 1.0, "decode and prefill pick different "
              "greedy tokens")

    # serving: 8 requests through 4 slots, then where a step's time goes
    out["serve"] = _serve_run("lm", cfg, params, rng)
    out["serve"]["profile"] = _decode_profile("lm", cfg, params, LM_SLOTS)
    del params
    torch.cuda.empty_cache()
    keep["lm"] = True


def _serve_run(tag: str, cfg, params, rng, max_len: int = LM_MAX_LEN) -> dict:
    """``ServeEngine(slots=LM_SLOTS, max_len=max_len)`` answering
    LM_REQUESTS requests of LM_NEW new tokens (prompts of 16-128 tokens
    from ``rng``), each step timed to its synchronise; fails unless every
    request is answered in full."""
    import numpy as np
    import torch
    from repro_torch.runtime import Request, ServeEngine
    engine = ServeEngine(cfg, params, slots=LM_SLOTS, max_len=max_len)
    step_ms = []
    step_fn = engine.step_fn

    def timed(*a):
        t = time.perf_counter()
        r = step_fn(*a)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        return r

    engine.step_fn = timed
    lengths = rng.integers(16, 129, LM_REQUESTS)
    for uid, n in enumerate(lengths):
        engine.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=LM_NEW))
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    generated = sum(len(r.generated) for r in done)
    caches = engine.caches
    cache_bytes = sum(t.numel() * t.element_size() for part in
                      (caches.kv, caches.ssm) if part is not None
                      for t in part)
    out = dict(requests=len(done), steps=engine.steps,
               prompt_lengths=[int(n) for n in lengths],
               generated=generated, seconds=serve_s,
               generated_per_s=generated / serve_s,
               median_step_ms=float(np.median(step_ms)),
               kv_cache_bytes=cache_bytes)
    log(f"[{tag}] ServeEngine(slots={LM_SLOTS}, max_len={max_len}): "
        f"{len(done)}/{LM_REQUESTS} requests (prompts of "
        f"{int(lengths.min())}-{int(lengths.max())} tokens), {engine.steps} "
        f"steps in {serve_s:.2f} s, {generated} tokens generated = "
        f"{generated / serve_s:.1f} tokens/s, median step "
        f"{np.median(step_ms):.2f} ms, caches {cache_bytes / 1e9:.2f} GB")
    check(len(done) == LM_REQUESTS and all(
        len(r.generated) == LM_NEW for r in done),
        f"{tag}: served {len(done)} of {LM_REQUESTS} requests")
    return out


def _decode_profile(tag: str, cfg, params, slots: int,
                    max_len: int = 8) -> dict:
    """Where a decode step's time goes: four decode steps of ``slots``
    slots over caches of ``max_len``, unprofiled then under the profiler
    (the device's busy share of the unprofiled wall)."""
    import torch
    from repro_torch.models import decode_step, init_decode_state
    st0 = init_decode_state(cfg, slots, max_len, device="cuda")
    if cfg.modality in ("vision", "audio"):
        emb = torch.zeros((slots, 1, cfg.d_model), dtype=cfg.act_dtype,
                          device="cuda")
        inputs = dict(tokens=None, embeds=emb)
    else:
        inputs = dict(tokens=torch.zeros((slots, 1), dtype=torch.int32,
                                         device="cuda"))

    def four_steps():
        st = st0
        for _ in range(4):
            _, st = decode_step(params, cfg, state=st, **inputs)

    four_steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    four_steps()
    torch.cuda.synchronize()
    wall4 = time.perf_counter() - t0
    prof = _profile(four_steps)
    prof["wall_s"] = wall4
    prof["busy_share_of_unprofiled_wall"] = prof["busy_us"] / 1e6 / wall4
    log(f"[{tag}] 4 decode steps of {slots} slots: {1e3 * wall4:.1f} ms, "
        f"device busy {prof['busy_us'] / 1e3:.2f} ms = "
        f"{100 * prof['busy_share_of_unprofiled_wall']:.1f} % of it, "
        f"{prof['launches']} device operations")
    for row in prof["kernels"][:8]:
        log(f"[{tag}]   {row['device_us'] / 1e3:9.3f} ms  x{row['calls']:<4d} "
            f"{row['name']}")
    return prof


def _train_config():
    """The LM cell's model as phase train (a) trains it."""
    import dataclasses
    return dataclasses.replace(_lm_config(), remat="full")


def _train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (forward and backward, no
    recompute): 6·N·T for the N parameters (the tied table as the head)
    over T tokens, plus causal attention's 6·b·s²·H·dh per layer (half of
    QKᵀ and PV, times three)."""
    return (6 * cfg.n_params() * batch * seq
            + 6 * batch * seq * seq * cfg.n_heads * cfg.resolved_head_dim
            * cfg.n_layers)


def _train_profile(run) -> dict:
    """One ``run()`` under torch.profiler: device time by kernel and by
    part (K4, the attention backward, the GEMMs, the optimizer's foreach
    kernels, the rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e, own=True):
        name = "self_device_time_total" if own else "device_time_total"
        return getattr(e, name, getattr(e, name.replace("device", "cuda"),
                                        0.0))

    kernels, attn_bwd = [], 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            if dev_us(e) > 0:
                kernels.append((e.key, dev_us(e), e.count))
        elif e.key.endswith("_AttentionBackward"):
            # the autograd node's own range and the engine's range around
            # it both hold its kernels: take the larger, not the sum
            attn_bwd = max(attn_bwd, dev_us(e, own=False))
    kernels.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    parts = {"k4": 0.0, "gemm": 0.0, "foreach": 0.0, "other": 0.0}
    for name, us, _ in kernels:
        low = name.lower()
        if "flash_fwd" in low:
            parts["k4"] += us
        elif any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass",
                                    "sm90_", "splitk")):
            parts["gemm"] += us
        elif "multi_tensor_apply" in low:
            parts["foreach"] += us
        else:
            parts["other"] += us
    return dict(wall_us=wall_us, busy_us=busy, parts_us=parts,
                attention_backward_us=attn_bwd,
                launches=sum(r[2] for r in kernels),
                kernels=[dict(name=k[:90], device_us=us, calls=c)
                         for k, us, c in kernels[:15]])


def _train_full_width(out: dict, batch: int) -> None:
    """(a) at ``batch``: TRAIN_STEPS steps, then one profiled step."""
    import numpy as np
    import torch
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import init_train_state, make_train_step
    cfg = _train_config()
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=cfg.param_dtype)
    opt_state, comp_state = init_train_state(cfg, params)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    step_fn = make_train_step(cfg, AdamWConfig(**TRAIN_OPT))
    data = LMDataConfig(cfg.vocab_size, TRAIN_SEQ, batch)
    flops = _train_flops(cfg, batch, TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i in range(TRAIN_STEPS):
        b = lm_batch(data, i)
        kops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = step_fn(params, opt_state, comp_state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kops.launch_counts()
        params, opt_state, comp_state = o.params, o.opt_state, o.comp_state
        rows.append(dict(step=i + 1, s=wall, loss=float(o.metrics["loss"]),
                         grad_norm=float(o.metrics["grad_norm"]),
                         lr=float(o.metrics["lr"]),
                         k4_launches=counts["flash_attention"],
                         launches=counts))
        log(f"[train] (a) step {i + 1}: {1e3 * wall:.1f} ms, loss "
            f"{rows[-1]['loss']:.5f}, grad norm {rows[-1]['grad_norm']:.5f}, "
            f"lr {rows[-1]['lr']:.3e}, K4 launches {counts['flash_attention']}")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    steady = [r["s"] for r in rows[1:]]
    ms = 1e3 * float(np.median(steady))
    out.update(steps=rows, batch=batch, step_ms_median=ms,
               step_ms_first=1e3 * rows[0]["s"],
               tokens_per_s=batch * TRAIN_SEQ / (ms / 1e3), model_flops=flops,
               mfu=flops / (ms / 1e3) / PEAK_OPS["bfloat16"],
               k4_launches_per_step=rows[-1]["k4_launches"])
    log(f"[train] (a) {batch} x {TRAIN_SEQ} tokens a step: median "
        f"{ms:.1f} ms over steps 2-{TRAIN_STEPS} (first {out['step_ms_first']:.1f}"
        f" ms) = {out['tokens_per_s']:.0f} tokens/s; model FLOPs "
        f"{flops / 1e12:.2f} T a step (6·N·T, N = {cfg.n_params() / 1e9:.3f} "
        f"B, + causal attention 6·b·s²·H·dh·L) = "
        f"{100 * out['mfu']:.1f} % of the {PEAK_OPS['bfloat16'] / 1e12:.0f} "
        f"TFLOP/s bf16 peak; peak device memory "
        f"{out['peak_bytes'] / 1e9:.2f} GB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB; "
        f"init {out['init_s']:.1f} s")
    check(all(np.isfinite(r["loss"]) for r in rows), "non-finite loss")
    check(all(r["grad_norm"] > 0 and np.isfinite(r["grad_norm"])
              for r in rows), "a gradient norm is not positive and finite")
    check(all(r["k4_launches"] == 2 * cfg.n_layers for r in rows),
          f"K4 launched {[r['k4_launches'] for r in rows]} times a step "
          f"(expected {2 * cfg.n_layers}: the forward and the remat "
          "recompute of every layer)")
    b = lm_batch(data, TRAIN_STEPS)
    prof = _train_profile(lambda: step_fn(params, opt_state, comp_state, b))
    out["profile"] = prof
    parts = prof["parts_us"]
    log(f"[train] (a) profiled step: device busy {prof['busy_us'] / 1e3:.1f}"
        f" ms of {prof['wall_us'] / 1e3:.1f} ms wall, "
        f"{prof['launches']} device operations: K4 {parts['k4'] / 1e3:.2f} "
        f"ms, the attention backward (_AttentionBackward, its GEMMs "
        f"included) {prof['attention_backward_us'] / 1e3:.2f} ms, GEMMs "
        f"{parts['gemm'] / 1e3:.2f} ms, optimizer foreach kernels "
        f"{parts['foreach'] / 1e3:.2f} ms, other {parts['other'] / 1e3:.2f} "
        f"ms")
    for row in prof["kernels"]:
        log(f"[train]   {row['device_us'] / 1e3:9.2f} ms  x{row['calls']:<5d}"
            f" {row['name']}")


def _train_head(out: dict) -> None:
    """(a)'s LM head alone, forward and backward at its shape: h (b·s,
    d_model) bf16 against the float32 table (CUDA events)."""
    import torch
    from repro_torch.models.transformer import _ce_chunk
    cfg = _train_config()
    g = torch.Generator(device="cuda").manual_seed(3)
    t = out["batch"] * TRAIN_SEQ
    h = torch.randn((t, cfg.d_model), generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    table = (0.018 * torch.randn((cfg.padded_vocab, cfg.d_model),
                                 generator=g, device="cuda")).requires_grad_()
    labels = torch.randint(0, cfg.vocab_size, (t,), generator=g,
                           device="cuda")

    def head():
        loss = _ce_chunk(cfg, {"embed": {"table": table}}, h, labels)
        return torch.autograd.grad(loss, (h, table))

    out["head_ms"] = cuda_ms(head, reps=3)
    log(f"[train] (a) the LM head at ({t}, {cfg.d_model}) x "
        f"{cfg.padded_vocab}, forward and backward: {out['head_ms']:.2f} ms")


def _train_k4_autograd(out: dict) -> None:
    """(b) K4 under autograd at (a)'s attention shape, bf16, causal."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    cfg = _train_config()
    B, Hq, Hkv, S, D = (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, TRAIN_SEQ,
                        cfg.resolved_head_dim)
    q, k, v = (t.requires_grad_() for t in _k4_inputs(
        (B, Hq, S, D), Hkv, torch.bfloat16, seed=11))
    up = torch.randn((B, Hq, S, D), generator=torch.Generator(
        device="cuda").manual_seed(12), device="cuda").to(torch.bfloat16)
    kops.reset_launch_counts()
    got = kops.attention(q, k, v, causal=True)
    launches = kops.launch_counts()["flash_attention"]
    check(launches == 1, f"ops.attention launched K4 {launches} times")
    check(got.requires_grad, "ops.attention's output records no gradient")
    err, share = _k4_held(got.detach(), q.detach(), k.detach(), v.detach(),
                          True, 0)
    grads = torch.autograd.grad(got, (q, k, v), up)
    plain_in = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*plain_in, causal=True),
                               plain_in, up)
    equal = [bool(torch.equal(a, b)) for a, b in zip(grads, want)]
    log(f"[train] (b) K4 under autograd at ({B}, {Hq}, {S}, {D}) bf16 causal "
        f"(hkv {Hkv}): forward max|Δ| {err:.3e} ({share:.3f} of the "
        f"tolerance), one launch; dq, dk, dv bit-equal to the plain "
        f"version's autograd: {equal} (the backward differentiates the "
        f"plain version on the saved inputs, so this checks the Function's "
        f"wiring, not K4)")
    check(all(equal), "K4's gradients differ from the plain version's")

    fwd = cuda_ms(lambda: kops.attention(q.detach(), k.detach(), v.detach()),
                  reps=10)
    kept = kops.attention(q, k, v)
    bwd = cuda_ms(lambda: torch.autograd.grad(kept, (q, k, v), up,
                                              retain_graph=True), reps=5)
    lib_out = F.scaled_dot_product_attention(
        q, k.repeat_interleave(Hq // Hkv, 1), v.repeat_interleave(Hq // Hkv, 1),
        is_causal=True)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q.detach(), k.detach().repeat_interleave(Hq // Hkv, 1),
        v.detach().repeat_interleave(Hq // Hkv, 1), is_causal=True), reps=10)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (q, k, v), up, retain_graph=True), reps=5)
    plain = cuda_ms(lambda: ref.flash_attention_ref(
        q.detach(), k.detach(), v.detach()), reps=3)
    pairs = B * Hq * S * (S + 1) // 2
    bound, by = _bound_ms(4 * D * pairs, 2 * (2 * B * Hq + 2 * B * Hkv) * S
                          * D, "bfloat16")
    out["k4"] = dict(shape=[B, Hq, Hkv, S, D], max_abs_err=err,
                     tolerance_share=share, grads_bit_equal=equal, ms=fwd,
                     plain_ms=plain, bound_ms=bound, bound_by=by,
                     library_ms=lib_fwd, backward_ms=bwd,
                     library_backward_ms=lib_bwd)
    log(f"[train] (b) per layer: K4 forward {fwd:.3f} ms (plain {plain:.3f} "
        f"ms, scaled_dot_product_attention {lib_fwd:.3f} ms, bound "
        f"{bound:.3f} ms, {by}); the backward through the plain version "
        f"{bwd:.3f} ms (SDPA's backward, K/V expanded, {lib_bwd:.3f} ms)")


def _train_driver(out: dict) -> None:
    """(c) the launcher's driver at build_small_cfg through K4's SIMT
    instance, uninterrupted and with one StepFailure."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.train import build_small_cfg, make_driver
    from repro_torch.runtime import StepFailure
    cfg = build_small_cfg(LM_ARCH, use_pallas=True)
    shape = (TRAIN_BATCH, cfg.n_heads, TRAIN_SEQ, cfg.resolved_head_dim)
    err, share = _k4_check(*_k4_inputs(shape, cfg.n_kv_heads, torch.float32,
                                       seed=13), True, 0)
    out["driver_k4"] = dict(shape=list(shape), hkv=cfg.n_kv_heads,
                            max_abs_err=err, tolerance_share=share)
    log(f"[train] (c) K4's SIMT instance at the driver's shape {shape} "
        f"(hkv {cfg.n_kv_heads}) float32 causal: max|Δ| {err:.3e}, "
        f"{share:.3f} of the tolerance (atol {K4_ATOL:g})")
    runs = {}
    for name, fail_at in (("clean", None), ("restart", TRAIN_FAIL_AT)):
        fails = {fail_at}

        def hook(step, fails=fails):
            if step in fails:
                fails.discard(step)
                raise StepFailure(f"injected at step {step}")

        with tempfile.TemporaryDirectory() as ckpt:
            drv = make_driver(cfg, steps=TRAIN_DRIVER_STEPS,
                              batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                              lr=TRAIN_OPT["lr"], ckpt_dir=ckpt,
                              ckpt_every=TRAIN_CKPT_EVERY, device="cuda",
                              fault_hook=hook)
            kops.reset_launch_counts()
            t0 = time.perf_counter()
            drv.run()
            torch.cuda.synchronize()
            runs[name] = dict(
                s=time.perf_counter() - t0, restarts=drv.restarts,
                losses=[m["loss"] for m in drv.metrics_log],
                launches=kops.launch_counts()["flash_attention"])
        del drv
    clean, rest = runs["clean"], runs["restart"]
    replay = rest["losses"]
    resumed = TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
    want = clean["losses"][:TRAIN_FAIL_AT] + clean["losses"][resumed:]
    exact = replay == want
    rel = max(abs(a - b) / abs(b) for a, b in zip(replay, want))
    out["driver"] = dict(runs, bit_equal=exact, max_rel=rel,
                         cfg=dict(n_layers=cfg.n_layers, d_model=cfg.d_model,
                                  n_params=cfg.n_params()))
    log(f"[train] (c) {LM_ARCH} build_small_cfg ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_params() / 1e6:.1f} M parameters, "
        f"float32, K4's SIMT instance at D = {cfg.resolved_head_dim}): "
        f"TrainDriver over {TRAIN_DRIVER_STEPS} steps, checkpoints every "
        f"{TRAIN_CKPT_EVERY}: clean {clean['s']:.1f} s ({clean['launches']} "
        f"K4 launches), with a StepFailure at step {TRAIN_FAIL_AT} "
        f"{rest['s']:.1f} s, {rest['restarts']} restart, resumed at step "
        f"{resumed} ({rest['launches']} K4 launches); losses "
        f"{clean['losses'][0]:.5f} -> {clean['losses'][-1]:.5f}; the "
        f"restarted run's {len(replay)} losses "
        f"{'bit-equal to' if exact else 'differ from'} the clean run's "
        f"(max rel {rel:.3e})")
    check(rest["restarts"] == 1, f"{rest['restarts']} restarts, expected 1")
    check(len(rest["losses"]) == TRAIN_DRIVER_STEPS + TRAIN_FAIL_AT - resumed,
          f"{len(rest['losses'])} steps run")
    check(all(np.isfinite(clean["losses"])), "non-finite losses in (c)")
    per_step = 2 * cfg.n_layers
    check(clean["launches"] == per_step * TRAIN_DRIVER_STEPS
          and rest["launches"] == per_step * len(rest["losses"]),
          f"K4 launches {clean['launches']} / {rest['launches']}, expected "
          f"{per_step} a step")
    check(rel <= TRAIN_LOSS_RTOL, f"restart losses off by {rel:.3e}")


def phase_train(res: dict, keep: dict) -> None:
    """(a) phi4-mini-3.8b at full width, 4 AdamW steps; (b) K4 under
    autograd; (c) the launcher's TrainDriver with one restart."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = res["train"] = dict(arch=LM_ARCH, seq=TRAIN_SEQ,
                              held_bytes=torch.cuda.memory_allocated())
    _train_full_width(out, TRAIN_BATCH)
    torch.cuda.empty_cache()
    _train_head(out)
    torch.cuda.empty_cache()
    _train_k4_autograd(out)
    torch.cuda.empty_cache()
    _train_driver(out)
    torch.cuda.empty_cache()
    keep["train"] = True


# ------------------------------------------- training the LM families

def _family_train_config(arch: str, **cut):
    """A family cell as phase train_families trains it."""
    import dataclasses
    return dataclasses.replace(_family_config(arch), remat="full", **cut)


def _k4_uses(cfg) -> int:
    """Attention layers (uses of the shared block) in one forward."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers


def _k4_per_train_step(cfg) -> int:
    """K4 launches in one step under remat "full" or "dots" (attention's
    output is not a matrix product, so "dots" recomputes it too): every
    attention layer's forward and its recompute, but deepseek's layer0
    once (the reference does not rematerialise it)."""
    uses = _k4_uses(cfg)
    if cfg.family == "moe" and cfg.moe.first_dense_ff:
        return 2 * uses - 1
    return 2 * uses


def _touched_params(cfg) -> int:
    """The parameters one token's forward multiplies through: every
    layer's matrices (the moe family's top-k routed experts, shared experts
    and router; the hybrid's shared block once per use) and the head (the
    LM head, or the codebook head from embeddings). The input table is a
    lookup and is not counted (a tied table is counted once, as the
    head)."""
    emb = cfg.padded_vocab * cfg.d_model
    n = cfg.n_active_params()
    if not cfg.tie_embeddings:
        n -= emb
    if cfg.modality == "audio" and cfg.num_codebooks > 1:
        n += cfg.d_model * cfg.num_codebooks * cfg.padded_vocab - emb
    if cfg.family == "hybrid":
        d = cfg.d_model
        shared = 4 * d * cfg.n_heads * cfg.resolved_head_dim \
            + 3 * d * cfg.d_ff + 2 * d
        n += (_k4_uses(cfg) - 1) * shared
    return n


def _family_train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6·N·T for the N parameters one
    token touches (``_touched_params``) over T tokens, plus causal
    attention's 6·b·s²·H·dh per attention layer or use; the SSD's own
    products (its chunk Grams and states) are not counted."""
    attn = 0
    if _k4_uses(cfg):
        attn = 6 * batch * seq * seq * cfg.n_heads * cfg.resolved_head_dim \
            * _k4_uses(cfg)
    return 6 * _touched_params(cfg) * batch * seq + attn


def _tree_bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _train_family_cell(arch: str, cut: dict, res: dict) -> None:
    """(a) one family cell: TRAIN_STEPS steps, then one profiled step."""
    import gc

    import numpy as np
    import torch
    from repro_torch.data import LMDataConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.train import batch_for_step
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import init_train_state, make_train_step
    from torch.utils._pytree import tree_leaves
    tag = "train_families"
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = _family_train_config(arch, **cut)
    out = res["train_families"]["cells"][arch] = dict(
        family=cfg.family, n_layers=cfg.n_layers, cut=cut,
        published_layers=_family_config(arch).n_layers,
        held_bytes=torch.cuda.memory_allocated())
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=cfg.param_dtype)
    opt_state, comp_state = init_train_state(cfg, params)
    torch.cuda.synchronize()
    out.update(init_s=time.perf_counter() - t0,
               param_bytes=_tree_bytes(params),
               n_params=sum(t.numel() for t in tree_leaves(params)),
               touched_params=_touched_params(cfg))
    step_fn = make_train_step(cfg, AdamWConfig(**TRAIN_OPT))
    data = LMDataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    flops = _family_train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    k4_want = _k4_per_train_step(cfg)
    log(f"[{tag}] {arch} ({cfg.family}): {cfg.n_layers} of "
        f"{out['published_layers']} layers, d_model {cfg.d_model}, "
        f"{out['n_params'] / 1e9:.4f} B parameters ({16 * out['n_params'] / 1e9:.2f}"
        f" GB at 16 bytes a parameter), {out['touched_params'] / 1e9:.4f} B "
        f"touched a token; float32 masters, m, v "
        f"{3 * out['param_bytes'] / 1e9:.2f} GB made in {out['init_s']:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i in range(TRAIN_STEPS):
        b = batch_for_step(cfg, data, i)
        kops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = step_fn(params, opt_state, comp_state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kops.launch_counts()
        params, opt_state, comp_state = o.params, o.opt_state, o.comp_state
        rows.append(dict(step=i + 1, s=wall, loss=float(o.metrics["loss"]),
                         grad_norm=float(o.metrics["grad_norm"]),
                         k4_launches=counts["flash_attention"]))
        log(f"[{tag}] {arch} step {i + 1}: {1e3 * wall:.1f} ms, loss "
            f"{rows[-1]['loss']:.5f}, grad norm {rows[-1]['grad_norm']:.5f}, "
            f"K4 launches {counts['flash_attention']}")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    ms = 1e3 * float(np.median([r["s"] for r in rows[1:]]))
    out.update(steps=rows, step_ms_median=ms,
               step_ms_first=1e3 * rows[0]["s"],
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
               model_flops=flops,
               mfu=flops / (ms / 1e3) / PEAK_OPS["bfloat16"],
               k4_launches_per_step=rows[-1]["k4_launches"])
    check(all(np.isfinite(r["loss"]) for r in rows), f"{arch}: non-finite loss")
    check(all(r["grad_norm"] > 0 and np.isfinite(r["grad_norm"])
              for r in rows), f"{arch}: a gradient norm is not positive and "
          "finite")
    check(all(r["k4_launches"] == k4_want for r in rows),
          f"{arch}: K4 launched {[r['k4_launches'] for r in rows]} times a "
          f"step (expected {k4_want})")
    b = batch_for_step(cfg, data, TRAIN_STEPS)
    prof = _train_profile(lambda: step_fn(params, opt_state, comp_state, b))
    out["profile"] = prof
    parts = prof["parts_us"]
    log(f"[{tag}] {arch} at {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: "
        f"median {ms:.1f} ms over steps 2-{TRAIN_STEPS} (first "
        f"{out['step_ms_first']:.1f} ms) = {out['tokens_per_s']:.0f} "
        f"tokens/s; model FLOPs {flops / 1e12:.2f} T a step = "
        f"{100 * out['mfu']:.1f} % of the bf16 peak (N = the parameters one "
        f"token touches); peak device memory {out['peak_bytes'] / 1e9:.2f} GB"
        f" ({out['held_bytes'] / 1e9:.2f} GB held before); K4 {k4_want} "
        f"launches a step; profiled step: busy {prof['busy_us'] / 1e3:.1f} ms"
        f" of {prof['wall_us'] / 1e3:.1f} ms wall, {prof['launches']} device "
        f"operations: K4 {parts['k4'] / 1e3:.2f} ms, the attention backward "
        f"{prof['attention_backward_us'] / 1e3:.2f} ms, GEMMs "
        f"{parts['gemm'] / 1e3:.2f} ms, optimizer foreach "
        f"{parts['foreach'] / 1e3:.2f} ms, other {parts['other'] / 1e3:.2f} ms")
    for row in prof["kernels"][:8]:
        log(f"[{tag}]   {row['device_us'] / 1e3:9.2f} ms  x{row['calls']:<5d}"
            f" {row['name']}")
    del params, opt_state, comp_state, step_fn, o
    gc.collect()
    torch.cuda.empty_cache()


def _train_family_k4(res: dict) -> None:
    """K4 forward at each attention cell's training shape, bf16 causal,
    against its plain version, timed beside the plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    rows = res["train_families"]["k4"] = {}
    for arch in (MOE_ARCH, ZAMBA_ARCH, AUDIO_ARCH):
        cfg = _family_config(arch)
        B, Hq, Hkv, S, D = (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads,
                            TRAIN_SEQ, cfg.resolved_head_dim)
        q, k, v = _k4_inputs((B, Hq, S, D), Hkv, torch.bfloat16, seed=21)
        err, share = _k4_check(q, k, v, True, 0)
        ms = cuda_ms(lambda: flash_attention(q, k, v), reps=20)
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v), reps=5)
        kx = k.repeat_interleave(Hq // Hkv, dim=1)
        vx = v.repeat_interleave(Hq // Hkv, dim=1)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, is_causal=True), reps=20)
        pairs = B * Hq * S * (S + 1) // 2
        bound, by = _bound_ms(4 * D * pairs, 2 * (2 * B * Hq + 2 * B * Hkv)
                              * S * D, "bfloat16")
        rows[arch] = dict(shape=[B, Hq, Hkv, S, D], max_abs_err=err,
                          tolerance_share=share, ms=ms, plain_ms=plain,
                          library_ms=lib, bound_ms=bound, bound_by=by)
        log(f"[train_families] K4 at {arch}'s training shape ({B}, {Hq}, "
            f"{S}, {D}) hkv {Hkv} bf16 causal: max|Δ| {err:.3e} ({share:.3f} "
            f"of the tolerance); kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"scaled_dot_product_attention (K/V expanded) {lib:.3f} ms, "
            f"bound {bound:.4f} ms ({by})")
        del q, k, v, kx, vx


def _small_train_cfg(arch: str, **over):
    import dataclasses
    from repro_torch.launch.train import build_small_cfg
    return dataclasses.replace(build_small_cfg(arch), use_pallas=True,
                               **over)


def _train_family_routes(res: dict) -> None:
    """(b) K4's route against the plain route at build_small_cfg."""
    import dataclasses

    import torch
    from repro_torch.data import LMDataConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.train import batch_for_step
    from repro_torch.models import init_model, loss_fn
    from repro_torch.models import moe as moe_mod
    from torch.utils._pytree import (keystr, tree_flatten_with_path,
                                     tree_unflatten)

    def record(a, disp):
        return dict(expert=disp.expert.cpu(), keep=disp.keep.cpu(),
                    slot=disp.slot.cpu())

    def loss_and_grads(cfg, params, spec, batch):
        leaves = [p.detach().requires_grad_() for p in params]
        tree = tree_unflatten(leaves, spec)
        loss = loss_fn(tree, cfg, batch.get("tokens"), batch["labels"],
                       embeds=batch.get("embeds"))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return float(loss.detach()), grads

    rows = res["train_families"]["routes"] = {}
    for arch in TRAIN_SMALL_ARCHS:
        cfg = _small_train_cfg(arch)
        params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda", dtype=cfg.param_dtype)
        flat, spec = tree_flatten_with_path(params)
        names = [keystr(k) for k, _ in flat]
        leaves = [v for _, v in flat]
        data = LMDataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
        batch = {k: v.cuda() for k, v in batch_for_step(cfg, data, 0).items()}
        plain_cfg = dataclasses.replace(cfg, use_pallas=False)
        with _Timed(moe_mod, "dispatch", record) as rec:
            want_loss, want = loss_and_grads(plain_cfg, leaves, spec, batch)
        flips = None
        if rec.calls:
            with _Timed(moe_mod, "dispatch", record) as free:
                loss_and_grads(cfg, leaves, spec, batch)
            k = cfg.moe.top_k
            flips = sum(int(((a["expert"] != b["expert"])
                             | (a["keep"] != b["keep"])).reshape(-1, k)
                            .any(-1).sum())
                        for a, b in zip(rec.calls, free.calls))
        kops.reset_launch_counts()
        with _Replay(rec.calls):
            got_loss, got = loss_and_grads(cfg, leaves, spec, batch)
        launches = kops.launch_counts()["flash_attention"]
        worst, where, zero = 0.0, None, []
        for name, a, b in zip(names, got, want):
            scale = float(b.norm())
            if scale == 0:
                check(not a.any(), f"{arch}: {name}'s gradient is zero on "
                      "the plain route only")
                zero.append(name)
                continue
            rel = float((a - b).norm()) / scale
            if rel > worst:
                worst, where = rel, name
        loss_rel = abs(got_loss - want_loss) / abs(want_loss)
        rows[arch] = dict(loss=got_loss, plain_loss=want_loss,
                          loss_rel=loss_rel, grad_rel_max=worst,
                          grad_rel_leaf=where, zero_leaves=zero,
                          k4_launches=launches, routing_flips_free=flips,
                          n_params=sum(t.numel() for t in leaves))
        log(f"[train_families] (b) {arch} build_small_cfg ({cfg.n_layers} "
            f"layers, d_model {cfg.d_model}, {rows[arch]['n_params'] / 1e6:.1f}"
            f" M parameters, float32, {TRAIN_BATCH} x {TRAIN_SEQ}): K4 route "
            f"({launches} launches) against the plain route: loss "
            f"{got_loss:.7f} / {want_loss:.7f} (rel {loss_rel:.3e}); worst "
            f"gradient leaf {where} at {worst:.3e} of its norm; zero on both "
            f"{zero}" + ("" if flips is None else
                         f"; routing replayed (the free K4 run's experts or "
                         f"kept flags differ at {flips} token-layers)"))
        # build_small_cfg keeps remat="dots", which recomputes attention
        check(launches == _k4_per_train_step(cfg),
              f"{arch}: K4 launched {launches} times in (b), expected "
              f"{_k4_per_train_step(cfg)}")
        check(loss_rel <= TRAIN_ROUTE_LOSS_RTOL,
              f"{arch}: the K4 route's loss off by {loss_rel:.3e}")
        check(worst <= TRAIN_ROUTE_GRAD_RTOL,
              f"{arch}: gradient {where} off by {worst:.3e} of its norm")
        del params, leaves, got, want
        torch.cuda.empty_cache()


def _train_family_driver(res: dict) -> None:
    """(c) the launcher's driver at build_small_cfg, uninterrupted and with
    one StepFailure, for TRAIN_DRIVER_ARCHS."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.train import make_driver
    from repro_torch.runtime import StepFailure
    rows = res["train_families"]["driver"] = {}
    resumed = TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
    for arch in TRAIN_DRIVER_ARCHS:
        cfg = _small_train_cfg(arch)
        runs = {}
        for name, fail_at in (("clean", None), ("restart", TRAIN_FAIL_AT)):
            fails = {fail_at}

            def hook(step, fails=fails):
                if step in fails:
                    fails.discard(step)
                    raise StepFailure(f"injected at step {step}")

            with tempfile.TemporaryDirectory() as ckpt:
                drv = make_driver(cfg, steps=TRAIN_DRIVER_STEPS,
                                  batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                  lr=TRAIN_OPT["lr"], ckpt_dir=ckpt,
                                  ckpt_every=TRAIN_CKPT_EVERY, device="cuda",
                                  fault_hook=hook)
                kops.reset_launch_counts()
                t0 = time.perf_counter()
                drv.run()
                torch.cuda.synchronize()
                runs[name] = dict(
                    s=time.perf_counter() - t0, restarts=drv.restarts,
                    losses=[m["loss"] for m in drv.metrics_log],
                    launches=kops.launch_counts()["flash_attention"])
            del drv
            torch.cuda.empty_cache()
        clean, rest = runs["clean"], runs["restart"]
        want = clean["losses"][:TRAIN_FAIL_AT] + clean["losses"][resumed:]
        exact = rest["losses"] == want
        rows[arch] = dict(runs, bit_equal=exact)
        log(f"[train_families] (c) {arch} build_small_cfg under TrainDriver, "
            f"{TRAIN_DRIVER_STEPS} steps at {TRAIN_BATCH} x {TRAIN_SEQ}, "
            f"checkpoints every {TRAIN_CKPT_EVERY}: clean {clean['s']:.1f} s "
            f"({clean['launches']} K4 launches), with a StepFailure at step "
            f"{TRAIN_FAIL_AT} {rest['s']:.1f} s, {rest['restarts']} restart, "
            f"resumed at step {resumed}; losses {clean['losses'][0]:.5f} -> "
            f"{clean['losses'][-1]:.5f}; the restarted run's "
            f"{len(rest['losses'])} losses "
            f"{'bit-equal to' if exact else 'differ from'} the clean run's")
        check(rest["restarts"] == 1, f"{arch}: {rest['restarts']} restarts")
        check(all(np.isfinite(clean["losses"])), f"{arch}: non-finite loss")
        check(exact, f"{arch}: the restarted run's losses differ from the "
              f"clean run's: {rest['losses']} against {want}")


def phase_train_families(res: dict, keep: dict) -> None:
    """Training the moe, ssm, hybrid and audio families: K4 at their
    training shapes, (a) the four cells at full width, (b) K4's route
    against the plain route at build_small_cfg for the six archs, (c) the
    launcher's driver with a restart."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res["train_families"] = dict(cells={}, seq=TRAIN_SEQ, batch=TRAIN_BATCH)
    _train_family_k4(res)
    for arch, cut in TRAIN_FAMILIES:
        _train_family_cell(arch, cut, res)
    _train_family_routes(res)
    _train_family_driver(res)
    keep["train_families"] = True


# ------------------------------------------------------- the LM families

def _family_model(tag: str, cfg, out: dict):
    """Random bf16 weights from seed 0 on the card, with their size."""
    import gc

    import torch
    from repro_torch.models import init_model
    gc.collect()     # an engine in a reference cycle may hold the last model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    out.update(arch=cfg.name, n_params=cfg.n_params(), held_bytes=held,
               init_s=time.perf_counter() - t0,
               param_bytes=torch.cuda.memory_allocated() - held)
    log(f"[{tag}] {cfg.name} ({cfg.family}): {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), "
        f"{cfg.n_params() / 1e9:.3f} B parameters: "
        f"{out['param_bytes'] / 1e9:.2f} GB of {cfg.dtype} weights made in "
        f"{out['init_s']:.1f} s")
    return params


def _family_prefill(tag: str, cfg, params, inputs: dict, k4: int,
                    out: dict):
    """The cell's prefill of 1 x LM_SEQ: a first run, then the measured run
    with the launch counts zeroed just before and read just after (K4
    ``k4`` times), its peak memory above the weights, its profile. Returns
    the logits."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import forward
    t0 = time.perf_counter()
    forward(params, cfg, **inputs)
    torch.cuda.synchronize()
    out["first_prefill_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = forward(params, cfg, **inputs).logits
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    out.update(prefill_s=wall, tokens_per_s=LM_SEQ / wall, launches=counts,
               peak_bytes=torch.cuda.max_memory_allocated() - base,
               logits_shape=list(logits.shape))
    log(f"[{tag}] prefill 1 x {LM_SEQ}: {wall:.3f} s = {LM_SEQ / wall:.0f} "
        f"tokens/s (first run {out['first_prefill_s']:.2f} s); launches "
        f"{counts}; peak device memory {out['peak_bytes'] / 1e9:.2f} GB above "
        f"the weights; logits {tuple(logits.shape)}")
    vocab = ((cfg.num_codebooks, cfg.padded_vocab) if cfg.num_codebooks > 1
             else (cfg.padded_vocab,))
    check(tuple(logits.shape) == (1, LM_SEQ) + vocab
          and logits.dtype == torch.float32,
          f"{tag}: logits {logits.dtype} {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
    check(counts["flash_attention"] == k4,
          f"{tag}: flash_attention launched {counts['flash_attention']} "
          f"times in the prefill (expected {k4})")
    prof = _profile(lambda: forward(params, cfg, **inputs))
    prof["busy_share_of_unprofiled_wall"] = prof["busy_us"] / 1e6 / wall
    out["profile"] = prof
    log(f"[{tag}] profiled prefill: device busy {prof['busy_us'] / 1e3:.1f} "
        f"ms = {100 * prof['busy_share_of_unprofiled_wall']:.1f} % of the "
        f"unprofiled {1e3 * wall:.0f} ms, {prof['launches']} device "
        f"operations")
    for row in prof["kernels"][:10]:
        log(f"[{tag}]   {row['device_us'] / 1e3:9.2f} ms  x{row['calls']:<4d} "
            f"{row['name']}")
    return logits


def _check_logits(tag: str, what: str, got, want, out: dict) -> dict:
    """``_logit_parity`` of got against want, held to LM_LOGIT_RTOL at
    every position, and the arg-max to LM_ARGMAX_AGREE at the positions
    where ``want``'s top two logits lie further apart than that tolerance
    (the rule phase lm's decode check applies to its one position). The
    random models of phase families have flat logits: at many positions
    their top two lie closer than the tolerance, and there a difference
    within it may pick either; that share is reported beside the arg-max
    agreement over all positions."""
    import torch
    par = out[what] = _logit_parity(got, want)
    tol = LM_LOGIT_RTOL * par["max_logit"]
    top2 = torch.topk(want, 2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > tol
    same = got.argmax(-1) == want.argmax(-1)
    par["decided_share"] = float(decided.float().mean())
    par["argmax_agree_decided"] = (float(same[decided].float().mean())
                                   if decided.any() else None)
    log(f"[{tag}] {what}: max|Δ| {par['max_abs']:.4g} against a largest "
        f"|logit| {par['max_logit']:.4g} (tolerance {LM_LOGIT_RTOL:g} of it, "
        f"{tol:.4g}); the top two logits lie further apart than the "
        f"tolerance at {100 * par['decided_share']:.2f} % of the positions, "
        f"where the arg-max agrees at "
        + ("—" if par["argmax_agree_decided"] is None else
           f"{100 * par['argmax_agree_decided']:.2f} %")
        + f" (at least {100 * LM_ARGMAX_AGREE:g} %); over all positions at "
        f"{100 * par['argmax_agree']:.2f} %")
    check(par["max_abs"] <= tol, f"{tag} {what}: max|Δ| {par['max_abs']:.4g}")
    if par["argmax_agree_decided"] is not None:
        check(par["argmax_agree_decided"] >= LM_ARGMAX_AGREE,
              f"{tag} {what}: arg-max agrees at "
              f"{par['argmax_agree_decided']:.4f} of the decided positions")
    return par


def _family_decode(tag: str, cfg, params, inputs: dict, out: dict) -> None:
    """LM_DECODE_PROMPT decode steps (batch 1) against the prefill of the
    same inputs at its last position, each step timed."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step, forward, init_decode_state
    n = LM_DECODE_PROMPT
    key = "embeds" if "embeds" in inputs else "tokens"
    prompt = inputs[key][:, :n]
    full = forward(params, cfg, **{key: prompt}).logits[:, -1]
    st = init_decode_state(cfg, 1, n, device="cuda")
    ms = []
    for i in range(n):
        t = time.perf_counter()
        step = {key: prompt[:, i:i + 1]}
        if key == "embeds":
            step["tokens"] = None
        lg, st = decode_step(params, cfg, state=st, **step)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    out["decode_median_step_ms"] = float(np.median(ms))
    got = lg[:, 0]
    par = out["parity_decode"] = _logit_parity(got, full)
    rtol = par["rtol"] = SSM_DECODE_RTOL.get(cfg.name, LM_LOGIT_RTOL)
    top2 = torch.topk(full, 2, dim=-1).values
    gap = float((top2[..., 0] - top2[..., 1]).min())
    log(f"[{tag}] decode x{n} vs prefill, last position: max|Δ| "
        f"{par['max_abs']:.4g} against a largest |logit| "
        f"{par['max_logit']:.4g} = {par['max_abs'] / par['max_logit']:.4f} "
        f"of it (tolerance {rtol:.4g} of it); greedy tokens "
        f"{got.argmax(-1).flatten().tolist()} / "
        f"{full.argmax(-1).flatten().tolist()}, smallest top-2 gap "
        f"{gap:.4g}; median step {np.median(ms):.2f} ms")
    check(par["max_abs"] <= rtol * par["max_logit"],
          f"{tag} decode parity: max|Δ| {par['max_abs']:.4g}")
    if gap > rtol * par["max_logit"]:
        check(par["argmax_agree"] == 1.0, f"{tag}: decode and prefill pick "
              "different greedy tokens")


def _routing(calls: list[dict], t: int, k: int):
    """Per MoE layer and token: its experts in rank order and which of its
    assignments were kept, (layers, t, k) each."""
    import torch
    experts = torch.stack([c["expert"].reshape(t, k) for c in calls])
    kept = torch.stack([c["keep"].reshape(t, k) for c in calls])
    return experts, kept


class _Replay:
    """For the length of a ``with``: ``moe.dispatch`` replays ``calls``'
    routing (experts, slots, kept flags), layer by layer, with gate weights
    from the probabilities it is given (the reference's normalisation over
    the token's recorded experts)."""

    def __init__(self, calls: list[dict]):
        self.calls = list(calls)

    def __enter__(self) -> "_Replay":
        from repro_torch.models import moe as moe_mod
        self._inner = moe_mod.dispatch

        def replay(probs, k, cap):
            import torch
            rec = self.calls.pop(0)
            G, t_g, _ = probs.shape
            expert = rec["expert"].to(probs.device)
            keep = rec["keep"].to(probs.device)
            gate = probs.gather(2, expert.reshape(G, t_g, k))
            gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
            return moe_mod.Dispatch(expert, rec["slot"].to(probs.device),
                                    keep, torch.where(
                                        keep, gate.reshape(G, t_g * k), 0.0))
        moe_mod.dispatch = replay
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import moe as moe_mod
        moe_mod.dispatch = self._inner


def _moe_parity(tag: str, cfg, params, tokens, out: dict) -> None:
    """The prefill through K4 against the plain chunked attention. Routing
    is discontinuous, the GShard drop rule most of all: a bf16 difference
    in one token's router logits can flip its top-k choice, which moves
    the slots of the later tokens of its group that pick those experts and
    so which of them the capacity keeps. Both runs' routing is recorded
    layer by layer and their disagreement counted; the logits are held
    with the plain run's routing replayed in the K4 run (its gate weights
    from its own probabilities), so that they differ by the attention
    kernel alone, at every position (``_check_logits``)."""
    import dataclasses

    import torch
    from repro_torch.models import forward
    from repro_torch.models import moe as moe_mod

    def record(a, disp):
        return dict(expert=disp.expert.cpu(), keep=disp.keep.cpu(),
                    slot=disp.slot.cpu())

    k = cfg.moe.top_k
    runs = {}
    for name, c in (("plain", dataclasses.replace(cfg, use_pallas=False)),
                    ("k4", cfg)):
        with _Timed(moe_mod, "dispatch", record) as rec:
            t0 = time.perf_counter()
            logits = forward(params, c, tokens).logits
            torch.cuda.synchronize()
        runs[name] = (logits, rec.calls, time.perf_counter() - t0)
    plain, plain_calls, plain_s = runs["plain"]
    free, k4_calls, _ = runs.pop("k4")
    e1, k1 = _routing(k4_calls, LM_SEQ, k)
    e2, k2 = _routing(plain_calls, LM_SEQ, k)
    experts_differ = (e1 != e2).any(dim=-1)                   # (layers, t)
    kept_differ = (k1 != k2).any(dim=-1) & ~experts_differ
    agree = ~(experts_differ | kept_differ).any(dim=0)
    worst_free = (free - plain).abs().amax(dim=-1)[0]
    arg_free = (free.argmax(-1) == plain.argmax(-1))[0].cpu()
    del free
    with _Replay(plain_calls):
        got = forward(params, cfg, tokens).logits
        torch.cuda.synchronize()
    par = out["parity_plain"] = {}
    par.update(
        routing_replayed=True, plain_prefill_s=plain_s,
        dropped_share=[float((~kk).float().mean()) for kk in (k1, k2)],
        routing_agrees=int(agree.sum()),
        experts_differ_by_layer=[int(r.sum()) for r in experts_differ],
        only_kept_differ_by_layer=[int(r.sum()) for r in kept_differ],
        free_max_abs=float(worst_free.max()),
        free_max_abs_where_routing_agrees=float(
            worst_free[agree.to(worst_free.device)].max()) if agree.any()
        else None,
        free_argmax_agree=float(arg_free.float().mean()))
    log(f"[{tag}] the free runs' routing (plain {plain_s:.2f} s): "
        f"assignments dropped {par['dropped_share'][0]:.4f} (K4) / "
        f"{par['dropped_share'][1]:.4f} (plain); tokens whose experts "
        f"differ, by MoE layer {par['experts_differ_by_layer']}; whose "
        f"experts agree but kept flags differ "
        f"{par['only_kept_differ_by_layer']}; routing agrees in every layer "
        f"at {par['routing_agrees']} of {LM_SEQ} positions; free logits "
        f"max|Δ| {par['free_max_abs']:.4g} "
        f"({par['free_max_abs_where_routing_agrees']} where routing "
        f"agrees), arg-max agrees at "
        f"{100 * par['free_argmax_agree']:.2f} %")
    par.update(_check_logits(tag, "parity_plain_replayed", got, plain, out))


def _slot_reuse(tag: str, cfg, params, rng, out: dict) -> None:
    """A prompt served twice through one slot: the second request finds the
    slot's SSM state and KV entries of the first, which the engine hides
    (the state zeroed, ``start``). Their prompt steps, the same tokens,
    give the same logits up to rounding (the second request's RoPE
    positions are shifted), held to the cell's decode tolerance, and so
    the same first generated token where the top two logits lie further
    apart than it; after that the greedy tokens may part at a near tie and
    then feed different inputs, so their agreement is reported. The same
    run with the state kept, as the reference's engine does (R3), must
    move those logits by more than the tolerance: the check sees R3."""
    import numpy as np
    import torch
    from repro_torch.runtime import Request, ServeEngine
    prompt = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    rtol = SSM_DECODE_RTOL.get(cfg.name, LM_LOGIT_RTOL)

    def serve(reset: bool):
        engine = ServeEngine(cfg, params, slots=1, max_len=64)
        logits = []
        step_fn, admit = engine.step_fn, engine._admit

        def recorded(*a):
            lg, caches = step_fn(*a)
            logits.append(lg[0, -1].float().cpu())
            return lg, caches

        def admit_keeping_state():
            ssm = engine.caches.ssm
            engine.caches = engine.caches._replace(ssm=None)
            admit()
            engine.caches = engine.caches._replace(ssm=ssm)

        engine.step_fn = recorded
        if not reset:
            engine._admit = admit_keeping_state
        for uid in (0, 1):
            engine.submit(Request(uid=uid, prompt=prompt.copy(),
                                  max_new_tokens=8))
        done = {r.uid: r.generated for r in engine.run()}
        half = len(logits) // 2
        n = len(prompt)          # the prompt steps, the last one generating
        first, second = (torch.stack(logits[:n]),
                         torch.stack(logits[half:half + n]))
        return done, float((first - second).abs().max()), first

    done, diff, first = serve(reset=True)
    _, kept_diff, _ = serve(reset=False)
    scale = float(first.abs().max())
    top2 = torch.topk(first[-1], 2).values
    gap = float(top2[0] - top2[1])
    same = next((i for i, (a, b) in enumerate(zip(done[0], done[1]))
                 if a != b), len(done[0]))
    out["slot_reuse"] = dict(generated=[done.get(0), done.get(1)],
                             prompt_max_abs=diff, max_logit=scale,
                             rtol=rtol, first_gap=gap, tokens_equal=same,
                             state_kept_prompt_max_abs=kept_diff)
    log(f"[{tag}] one slot, the same prompt of {len(prompt)} twice: the "
        f"prompt steps' logits max|Δ| {diff:.4g} against a largest |logit| "
        f"{scale:.4g} (tolerance {rtol:.4g} of it); with the state kept as "
        f"the reference's engine keeps it, {kept_diff:.4g}; generated "
        f"{done.get(0)} and {done.get(1)}, equal for the first {same} "
        f"tokens (top-2 gap at the first {gap:.4g})")
    check(len(done) == 2 and diff <= rtol * scale,
          f"{tag}: a reused slot's prompt logits moved by {diff:.4g}")
    check(kept_diff > rtol * scale, f"{tag}: keeping the state moved the "
          f"prompt logits by only {kept_diff:.4g}")
    if gap > rtol * scale:
        check(same >= 1, f"{tag}: a reused slot's first token differs")


def _families_moe(res: dict, rng) -> None:
    """(a) deepseek-moe-16b at its published widths."""
    import torch
    tag = "families:moe"
    cfg = _family_config(MOE_ARCH)
    out = res["families"]["moe"] = {}
    params = _family_model(tag, cfg, out)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, LM_SEQ)),
                             dtype=torch.int32, device="cuda")
    _family_prefill(tag, cfg, params, dict(tokens=tokens), cfg.n_layers, out)
    _moe_parity(tag, cfg, params, tokens, out)
    torch.cuda.empty_cache()
    out["serve"] = _serve_run(tag, cfg, params, rng)
    out["serve"]["profile"] = _decode_profile(tag, cfg, params, LM_SLOTS)
    del params
    torch.cuda.empty_cache()


def _families_hybrid(res: dict, rng) -> None:
    """(b) zamba2-7b at its published widths."""
    import dataclasses

    import torch
    from repro_torch.models import forward
    tag = "families:hybrid"
    cfg = _family_config(ZAMBA_ARCH)
    out = res["families"]["hybrid"] = {}
    params = _family_model(tag, cfg, out)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, LM_SEQ)),
                             dtype=torch.int32, device="cuda")
    n_groups = cfg.n_layers // cfg.shared_attn_every
    logits = _family_prefill(tag, cfg, params, dict(tokens=tokens), n_groups,
                             out)
    t0 = time.perf_counter()
    plain = forward(params, dataclasses.replace(cfg, use_pallas=False),
                    tokens).logits
    torch.cuda.synchronize()
    out["plain_prefill_s"] = time.perf_counter() - t0
    _check_logits(tag, "parity_plain", logits, plain, out)
    del logits, plain
    torch.cuda.empty_cache()
    _family_decode(tag, cfg, params, dict(tokens=tokens), out)
    out["serve"] = _serve_run(tag, cfg, params, rng)
    out["serve"]["profile"] = _decode_profile(tag, cfg, params, LM_SLOTS)
    _slot_reuse(tag, cfg, params, rng, out)
    del params
    torch.cuda.empty_cache()


def _families_ssm_audio(res: dict, rng) -> None:
    """(c) mamba2-780m (no attention, so no port kernel) and
    musicgen-medium from embeddings, at their published widths."""
    import torch
    for arch, key in ((MAMBA_ARCH, "ssm"), (AUDIO_ARCH, "audio")):
        tag = f"families:{key}"
        cfg = _family_config(arch)
        out = res["families"][key] = {}
        params = _family_model(tag, cfg, out)
        if cfg.modality == "audio":
            g = torch.Generator(device="cuda").manual_seed(0)
            inputs = dict(embeds=torch.randn((1, LM_SEQ, cfg.d_model),
                                             generator=g, device="cuda")
                          .to(cfg.act_dtype))
            k4 = cfg.n_layers
        else:
            inputs = dict(tokens=torch.as_tensor(
                rng.integers(0, cfg.vocab_size, (1, LM_SEQ)),
                dtype=torch.int32, device="cuda"))
            k4 = 0
        logits = _family_prefill(tag, cfg, params, inputs, k4, out)
        del logits
        _family_decode(tag, cfg, params, inputs, out)
        out["decode_profile"] = _decode_profile(tag, cfg, params, 1)
        del params, inputs
        torch.cuda.empty_cache()


def phase_families(res: dict, keep: dict) -> None:
    """The moe, hybrid, ssm and audio families at their published widths,
    bf16, use_pallas, random weights from seed 0; one model at a time."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res["families"] = {}
    rng = np.random.default_rng(0)
    _families_moe(res, rng)
    _families_hybrid(res, rng)
    _families_ssm_audio(res, rng)
    keep["families"] = True


class _Selections:
    """Records every landmark selection that ``core.attention_nystrom``
    makes (the scores it ranked, the positions it kept; copied to the host)
    in call order while open; given ``replay`` (another run's records),
    each call returns that run's positions instead of its own."""

    def __init__(self, replay: list[dict] | None = None):
        self.calls: list[dict] = []
        self.replay = replay

    def __enter__(self):
        from repro_torch.core import attention_nystrom as an
        self._module, self._select = an, an.select_landmarks

        def select(scores, p):
            idx = self._select(scores, p)
            if self.replay is not None:
                idx = self.replay[len(self.calls)]["idx"].to(idx.device)
            self.calls.append(dict(scores=scores.float().cpu(),
                                   idx=idx.cpu()))
            return idx

        an.select_landmarks = select
        return self

    def __exit__(self, *exc) -> None:
        self._module.select_landmarks = self._select


def _rls_prefill(cfg, params, tokens, out: dict):
    """(a): the RLS prefill of 1 x LM_SEQ; a first run recording each
    layer's selection (the share of NaN score rows: R9 at full width),
    the measured run with the launch counts zeroed just before and read
    just after (no K4), its peak memory and profile. Returns the logits."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import forward
    t0 = time.perf_counter()
    with _Selections() as sel:
        forward(params, cfg, tokens)
        torch.cuda.synchronize()
    out["first_prefill_s"] = time.perf_counter() - t0
    rows = torch.cat([c["scores"].reshape(-1, c["scores"].shape[-1])
                      for c in sel.calls])
    nan_rows = int(torch.isnan(rows).any(-1).sum())
    out.update(selections=len(sel.calls), score_rows=rows.shape[0],
               nan_score_rows=nan_rows,
               nan_row_share=nan_rows / rows.shape[0])
    log(f"[rls] {len(sel.calls)} selections of {sel.calls[0]['idx'].shape[-1]}"
        f" landmarks: {nan_rows} of {rows.shape[0]} (layer, head) score rows"
        f" hold NaN (R9) = {100 * out['nan_row_share']:.2f} %")
    del sel, rows
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = forward(params, cfg, tokens).logits
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    out.update(prefill_s=wall, tokens_per_s=LM_SEQ / wall, launches=counts,
               peak_bytes=torch.cuda.max_memory_allocated() - base)
    log(f"[rls] RLS prefill 1 x {LM_SEQ}: {wall:.3f} s = "
        f"{LM_SEQ / wall:.0f} tokens/s (first run "
        f"{out['first_prefill_s']:.2f} s, recording); launches {counts}; "
        f"peak device memory {out['peak_bytes'] / 1e9:.2f} GB above the "
        f"weights")
    check(tuple(logits.shape) == (1, LM_SEQ, cfg.padded_vocab)
          and logits.dtype == torch.float32,
          f"rls: logits {logits.dtype} {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "rls: non-finite logits")
    check(counts["flash_attention"] == 0,
          f"rls: flash_attention launched {counts['flash_attention']} times "
          "in the RLS prefill (expected none)")
    prof = _profile(lambda: forward(params, cfg, tokens))
    prof["busy_share_of_unprofiled_wall"] = prof["busy_us"] / 1e6 / wall
    out["profile"] = prof
    log(f"[rls] profiled RLS prefill: device busy "
        f"{prof['busy_us'] / 1e3:.1f} ms = "
        f"{100 * prof['busy_share_of_unprofiled_wall']:.1f} % of the "
        f"unprofiled {1e3 * wall:.0f} ms, {prof['launches']} device "
        f"operations")
    for row in prof["kernels"][:12]:
        log(f"[rls]   {row['device_us'] / 1e3:9.2f} ms  x{row['calls']:<4d} "
            f"{row['name']}")
    return logits


def _rls_identity(cfg, out: dict) -> None:
    """(b): nystrom_attention at p = s against K4 on the same N(0, 1)
    inputs at the prefill's shape, bf16, causal, within RLS_IDENTITY_ATOL;
    both timed (CUDA events)."""
    import numpy as np
    import torch
    from repro_torch.core.attention_nystrom import nystrom_attention
    from repro_torch.kernels import ops as kops
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = np.random.default_rng(0)

    def normal(heads):
        return torch.from_numpy(g.standard_normal(
            (1, heads, LM_SEQ, dh)).astype(np.float32)).to(
            "cuda", torch.bfloat16)

    q, k, v = normal(h), normal(hkv), normal(hkv)
    kq = k.repeat_interleave(h // hkv, dim=1)
    vq = v.repeat_interleave(h // hkv, dim=1)
    lm = torch.arange(LM_SEQ, device="cuda").expand(1, h, LM_SEQ)

    def rls():
        return nystrom_attention(q, kq, vq, num_landmarks=LM_SEQ,
                                 landmarks=lm).out

    got = rls()
    k4 = kops.attention(q, k, v, causal=True)
    gap = float((got.float() - k4.float()).abs().max())
    out["identity"] = dict(
        shape=[1, h, LM_SEQ, dh], max_abs=gap, bound=RLS_IDENTITY_ATOL,
        max_out=float(k4.float().abs().max()),
        rls_ms=cuda_ms(rls, reps=3),
        k4_ms=cuda_ms(lambda: kops.attention(q, k, v, causal=True), reps=10))
    ident = out["identity"]
    log(f"[rls] (b) p = s: nystrom_attention against K4 at (1, {h}/{hkv}, "
        f"{LM_SEQ}, {dh}) bf16: max|Δ| {gap:.6g} (bound {RLS_IDENTITY_ATOL:g},"
        f" twice the JAX package's CPU gap {RLS_IDENTITY_GAP:g}), largest "
        f"|out| {ident['max_out']:.4g}; {ident['rls_ms']:.2f} ms against "
        f"K4's {ident['k4_ms']:.3f} ms")
    check(gap <= RLS_IDENTITY_ATOL,
          f"rls (b): p = s against K4 max|Δ| {gap:.6g}")


def _rls_serving(cfg, exact_cfg, params, out: dict) -> None:
    """(c): ServeEngine(slots=LM_SLOTS, max_len=RLS_MAX_LEN) answering the
    same LM_REQUESTS requests exactly and through the frozen landmarks,
    each with four profiled decode steps over caches of RLS_MAX_LEN."""
    import numpy as np
    p = min(cfg.nystrom_landmarks, RLS_MAX_LEN)
    for tag, c, read in (("exact", exact_cfg, RLS_MAX_LEN),
                         ("rls", cfg, p + max(cfg.rls_keep_recent, 1))):
        run = out[f"serve_{tag}"] = _serve_run(
            f"rls/{tag}", c, params, np.random.default_rng(1),
            max_len=RLS_MAX_LEN)
        run["entries_read_per_layer_step"] = read
        run["profile"] = _decode_profile(f"rls/{tag}", c, params, LM_SLOTS,
                                         RLS_MAX_LEN)
        log(f"[rls] (c) {tag}: {read} cache entries read a layer and step, "
            f"median step {run['median_step_ms']:.2f} ms, "
            f"{run['generated_per_s']:.1f} tokens/s, device busy "
            f"{100 * run['profile']['busy_share_of_unprofiled_wall']:.1f} %")


def _rls_selection_parity(cpu: list[dict], card: list[dict]) -> dict:
    """Per selection call: the rows (one per batch entry and head) whose
    scores hold NaN on either side (R9); in the other rows, the largest
    score difference, the rows whose landmarks are equal, and the rows
    where the CPU's p-th and (p+1)-th scores lie further apart than the two
    sides' scores differ there (the rows the scores decide, where the
    landmarks must be equal)."""
    import torch
    check(len(cpu) == len(card), f"rls (d): {len(cpu)} selections on the "
          f"CPU, {len(card)} on the card")
    rows = nan_cpu = nan_card = decided = same = equal = finite_rows = 0
    max_diff = 0.0
    for a, b in zip(cpu, card):
        sa = a["scores"].reshape(-1, a["scores"].shape[-1])
        sb = b["scores"].reshape(-1, b["scores"].shape[-1])
        ia = a["idx"].reshape(-1, a["idx"].shape[-1])
        ib = b["idx"].reshape(-1, b["idx"].shape[-1])
        p = ia.shape[-1]
        na, nb = torch.isnan(sa).any(-1), torch.isnan(sb).any(-1)
        rows += sa.shape[0]
        nan_cpu += int(na.sum())
        nan_card += int(nb.sum())
        both = sa.isfinite() & sb.isfinite()
        diff = torch.where(both, (sa - sb).abs(), torch.zeros_like(sa))
        ranked = torch.sort(sa, dim=-1, descending=True).values
        gap = (ranked[:, p - 1] - ranked[:, p] if p < sa.shape[-1]
               else torch.full_like(ranked[:, 0], float("inf")))
        finite = ~na & ~nb
        ok = finite & (gap > diff.amax(-1))
        decided += int(ok.sum())
        same += int((ia == ib).all(-1)[ok].sum())
        finite_rows += int(finite.sum())
        equal += int((ia == ib).all(-1)[finite].sum())
        if finite.any():
            max_diff = max(max_diff, float(diff[finite].max()))
    return dict(calls=len(cpu), rows=rows, nan_rows_cpu=nan_cpu,
                nan_rows_card=nan_card, finite_rows=finite_rows,
                max_score_diff=max_diff, equal_rows=equal,
                decided_rows=decided, equal_decided_rows=same)


def _rls_card_vs_cpu(arch: str, out: dict) -> None:
    """(d): the launcher's reduction with RLS attention, float32, the same
    weights (seed 0, made on the CPU and copied): a prefill of
    RLS_SMALL_SEQ tokens and RLS_SMALL_STEPS decode steps (frozen for the
    dense family, compressed for the hybrid) on the card and on the host's
    CPU. The card's selections are held against the CPU's where
    the scores decide them; the card's logits, with the CPU's selections
    replayed, within RLS_CPU_LOGIT_ATOL of the CPU's."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.launch.train import build_small_cfg
    from repro_torch.models import decode_step, forward, init_decode_state
    from repro_torch.models import init_model
    cfg = build_small_cfg(arch, **RLS_SMALL)
    host = init_model(cfg, device="cpu")
    card = tree_map(lambda a: a.to("cuda"), host)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, RLS_SMALL_SEQ)), dtype=torch.int32)

    def run(params, device, replay=None):
        with _Selections(replay) as sel:
            pre = forward(params, cfg, toks.to(device)).logits
            st = init_decode_state(cfg, 1, RLS_SMALL_SEQ, device=device)
            steps = []
            for i in range(RLS_SMALL_STEPS):
                lg, st = decode_step(params, cfg, toks[:, i:i + 1].to(device),
                                     st)
                steps.append(lg[:, 0])
        return pre.cpu(), torch.stack(steps, 1).cpu(), sel.calls

    t0 = time.perf_counter()
    want = run(host, "cpu")
    cpu_s = time.perf_counter() - t0
    free = run(card, "cuda")
    held = run(card, "cuda", replay=want[2])
    sel = _rls_selection_parity(want[2], free[2])
    res = out[f"cpu_{arch}"] = dict(
        cpu_s=cpu_s, selection=sel,
        decode=("compressed" if cfg.family == "hybrid" else "frozen"),
        prefill_max_abs=float((held[0] - want[0]).abs().max()),
        decode_max_abs=float((held[1] - want[1]).abs().max()),
        free_prefill_max_abs=float((free[0] - want[0]).abs().max()),
        free_decode_max_abs=float((free[1] - want[1]).abs().max()),
        max_logit=float(want[0].abs().max()))
    log(f"[rls] (d) {arch} (build_small_cfg, float32, {res['decode']} "
        f"decode): {sel['calls']} selections, {sel['rows']} score rows; NaN "
        f"rows (R9) {sel['nan_rows_cpu']} on the CPU, {sel['nan_rows_card']}"
        f" on the card; in the {sel['finite_rows']} others scores within "
        f"{sel['max_score_diff']:.3g}, landmarks equal in "
        f"{sel['equal_rows']} of them and in {sel['equal_decided_rows']} of "
        f"the {sel['decided_rows']} rows the scores decide. With the CPU's "
        f"selections: prefill max|Δ| {res['prefill_max_abs']:.3g}, "
        f"{RLS_SMALL_STEPS} decode steps {res['decode_max_abs']:.3g} (bound "
        f"{RLS_CPU_LOGIT_ATOL:g}, largest |logit| {res['max_logit']:.3g}); "
        f"with its own {res['free_prefill_max_abs']:.3g} / "
        f"{res['free_decode_max_abs']:.3g}; CPU run {cpu_s:.1f} s")
    check(sel["equal_decided_rows"] == sel["decided_rows"],
          f"rls (d) {arch}: the card selects other landmarks where the "
          "scores decide them")
    check(bool(torch.isfinite(held[0]).all() & torch.isfinite(held[1]).all()),
          f"rls (d) {arch}: non-finite logits")
    check(res["prefill_max_abs"] <= RLS_CPU_LOGIT_ATOL
          and res["decode_max_abs"] <= RLS_CPU_LOGIT_ATOL,
          f"rls (d) {arch}: the card's logits part from the CPU's")


def phase_rls(res: dict, keep: dict) -> None:
    """Nyström-RLS attention at the LM cell's published widths: (a) the RLS
    prefill, held against K4's exact prefill of the same weights and tokens
    (reported, not bounded: the weights are random); (b) the p = s
    identity against K4; (c) serving, exact and through frozen landmarks;
    (d) the card against the port's CPU path at the launcher's reduction."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import forward
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(_lm_config(), attn_approx="nystrom_rls")
    exact_cfg = dataclasses.replace(cfg, attn_approx="none")
    p = min(cfg.nystrom_landmarks, LM_SEQ)
    out = res["rls"] = dict(arch=LM_ARCH, seq=LM_SEQ, landmarks=p,
                            p_sketch=min(2 * p, LM_SEQ),
                            keep_recent=cfg.rls_keep_recent)
    part_s = out["part_s"] = {}
    t_part = time.perf_counter()

    def part(name: str) -> None:
        nonlocal t_part
        now = time.perf_counter()
        part_s[name] = now - t_part
        t_part = now
        log(f"[rls] ({name}) took {part_s[name]:.1f} s")

    params = _family_model("rls", cfg, out)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, LM_SEQ)), dtype=torch.int32, device="cuda")
    logits = _rls_prefill(cfg, params, tokens, out)
    t0 = time.perf_counter()
    exact = forward(params, exact_cfg, tokens).logits
    torch.cuda.synchronize()
    out["exact_prefill_s"] = time.perf_counter() - t0
    par = out["against_exact"] = _logit_parity(logits, exact)
    log(f"[rls] (a) against K4's exact prefill ({out['exact_prefill_s']:.3f}"
        f" s): max|Δ| {par['max_abs']:.4g} against a largest |logit| "
        f"{par['max_logit']:.4g}, arg-max agrees at "
        f"{100 * par['argmax_agree']:.2f} % of {LM_SEQ} positions (random "
        "weights: reported, not bounded)")
    del logits, exact
    torch.cuda.empty_cache()
    part("a")
    _rls_identity(cfg, out)
    torch.cuda.empty_cache()
    part("b")
    _rls_serving(cfg, exact_cfg, params, out)
    del params
    torch.cuda.empty_cache()
    part("c")
    for arch in (LM_ARCH, ZAMBA_ARCH):
        _rls_card_vs_cpu(arch, out)
    part("d")
    keep["rls"] = True


def _profile(run) -> dict:
    """Device time by kernel over one more ``run()`` (a fit and its
    predictions), under ``torch.profiler`` (CUPTI), and the device's busy
    share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((e.key, us, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return dict(wall_us=wall_us, busy_us=busy, busy_share=busy / wall_us,
                launches=sum(r[2] for r in rows),
                kernels=[dict(name=k[:90], device_us=us, calls=c)
                         for k, us, c in rows[:15]])


def _bound_ms(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _launches(res: dict, phase: str, kernel: str) -> int | None:
    """The kernel's launches in ``phase``'s run of the main path; None when
    that phase did not run, so no row shows a count nobody measured."""
    if phase not in res:
        return None
    return res[phase]["launches"].get(kernel, 0)


def _k1_row(shape: str, launches, err, ms, plain, bound, by, lib,
            **extra) -> dict:
    return dict(name="kernel_block", shape=shape, route="cuda",
                source="src/repro_torch/kernels/csrc/kernel_block.cu",
                replaces="src/repro/kernels/rbf_block.py:84",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib, **extra)


def _k1_bound(n: int, p: int, d: int, dtype: str,
              itemsize: int = 4) -> tuple[float, str]:
    """K1's dense bound: the cross term, the norms and the epilogue, against
    each input read once and the output written once."""
    ops = 2 * n * p * d + 2 * (n + p) * d + 5 * n * p
    return _bound_ms(ops, itemsize * (n * d + p * d + n * p), dtype)


def _k1_w_bound(Z, dtype: str = "float64",
                warp: tuple[int, int, int] = (32, 32, 8)
                ) -> tuple[float, str, float, float]:
    """The bound of W = k(Z, Z) over the work this Z needs: 2·Σ_c nnz_Z(c)²
    products (a zero of Z adds nothing), the norms over Z's non-zeros and
    the epilogue, against Z read twice and W written once, as K3's bound
    counts Σ_c nnz_X(c)·nnz_Z(c), at the peak of ``dtype``. Also returned,
    as shares of the dense 2·p²·d: that work, and the operations that the
    tensor-core build runs: a warp's step over ``warp`` = (its rows of X,
    its rows of Z, its k-values) for each pair of such row blocks of Z
    that both hold a non-zero in the same block of k-values (the warps
    skip the other steps, which add exact zeros): (32, 32, 8) for the FP64
    build, (64, 32, 16) for the bf16 one."""
    import torch
    p, d = Z.shape
    nz = Z != 0
    counts = nz.sum(0).double()
    work = 2 * float((counts * counts).sum())
    ops = work + 2 * 2 * float(counts.sum()) + 5 * p * p
    bound, by = _bound_ms(ops, Z.element_size() * (2 * p * d + p * p),
                          dtype)
    ra, rb, kw = warp
    kb = -(-d // kw)

    def live(rows):
        pad = torch.zeros((-(-p // rows) * rows, kb * kw), dtype=torch.bool,
                          device=Z.device)
        pad[:p, :d] = nz
        return pad.view(-1, rows, kb, kw).any(dim=3).any(dim=1).sum(0)

    mma = float(2 * ra * rb * kw * int((live(ra) * live(rb)).sum()))
    dense = 2 * p * p * d
    return bound, by, work / dense, mma / dense


def _k1_shape_row(label: str, X, Z, launches, reps: int) -> dict:
    """K1's rbf row at X's shape, float32, with its linear kind beside
    torch.matmul(X, Z.T) on the same tensors."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rbf_block import kernel_block
    (n, d), p = X.shape, Z.shape[0]
    err = float((kernel_block(X, Z, kind="rbf", bandwidth=BANDWIDTH)
                 - ref.rbf_block_ref(X, Z, BANDWIDTH)).abs().max())
    ms = cuda_ms(lambda: kernel_block(X, Z, kind="rbf", bandwidth=BANDWIDTH),
                 reps=reps)
    plain = cuda_ms(lambda: ref.rbf_block_ref(X, Z, BANDWIDTH), reps=reps)
    lin = cuda_ms(lambda: kernel_block(X, Z, kind="linear"), reps=reps)
    mm = cuda_ms(lambda: torch.matmul(X, Z.T), reps=reps)
    bound, by = _k1_bound(n, p, d, "float32")
    log(f"[summary] K1 rbf {label} (n,p,d)=({n},{p},{d}) f32: kernel "
        f"{1e3 * ms:.1f} µs, plain {1e3 * plain:.1f} µs, bound "
        f"{1e3 * bound:.2f} µs ({by}); linear kind {1e3 * lin:.1f} µs, "
        f"torch.matmul(X, Z.T) {1e3 * mm:.1f} µs; max|Δ| {err:.3e}, "
        f"launches on its path {launches}")
    check(err <= K1_TOL["float32"], f"K1 {label}: {err:.3e}")
    return _k1_row(label, launches, err, ms, plain, bound, by, None,
                   linear_ms=lin, linear_library_ms=mm,
                   library_fn="torch.matmul(X, Z.T) against the linear kind")


def _summary_k1(res: dict, keep: dict) -> list[dict]:
    """K1's rows at the three shapes that matter: the main path's fit
    (rbf; the linear kind beside torch.matmul(X, Z.T)), one predict batch
    of 256 rows, and the sparse path's W = k(Z, Z) over densified landmark
    rows (f32 data, f64 accumulation) beside torch.matmul on float64
    copies."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rbf_block import kernel_block
    if "Xtr" in keep:
        X = torch.as_tensor(keep["Xtr"], device="cuda")
        Z = keep["Z"].contiguous()
    else:       # the MSD-shaped rows, and landmarks drawn uniformly
        X = torch.as_tensor(_msd(keep)[0], device="cuda")
        Z = X[torch.randperm(N_TRAIN, generator=torch.Generator()
                             .manual_seed(6))[:P].cuda()].contiguous()
    n, d = X.shape
    p = Z.shape[0]
    fit_launches = predict_launches = None
    if "main" in res:
        fit_launches = res["main"]["fit_launches"]["kernel_block"]
        predict_launches = (res["main"]["launches"]["kernel_block"]
                            - fit_launches)
    rows = []
    # the fit's shape: the score pass's and the solver's columns
    C = kernel_block(X, Z, kind="rbf", bandwidth=BANDWIDTH)
    err1 = float((C - ref.rbf_block_ref(X, Z, BANDWIDTH)).abs().max())
    del C
    ms1 = cuda_ms(lambda: kernel_block(X, Z, kind="rbf",
                                       bandwidth=BANDWIDTH), reps=10)
    plain1 = cuda_ms(lambda: ref.rbf_block_ref(X, Z, BANDWIDTH), reps=10)
    b1, by1 = _k1_bound(n, p, d, "float32")
    lin_ms = cuda_ms(lambda: kernel_block(X, Z, kind="linear"), reps=10)
    mm_ms = cuda_ms(lambda: torch.matmul(X, Z.T), reps=10)
    log(f"[summary] K1 rbf (n,p,d)=({n},{p},{d}) f32 (SIMT): kernel "
        f"{ms1:.3f} ms, plain {plain1:.3f} ms, bound {b1:.3f} ms ({by1}), "
        f"max|Δ| {err1:.3e}, launches in the fit {fit_launches}")
    log(f"[summary] K1 linear same shape: kernel {lin_ms:.3f} ms, "
        f"torch.matmul(X, Z.T) {mm_ms:.3f} ms")
    check(err1 <= K1_TOL["float32"], f"K1 at main shape: {err1:.3e}")
    res["k1_linear_vs_matmul_ms"] = dict(kernel=lin_ms, matmul=mm_ms)
    # phase iter's launches at this shape: falkon_pcg's score pass, Csᵀy
    # and one gram_matvec an iteration
    iter_launches = (res["iter"]["a"]["fit_launches"]["kernel_block"] - 1
                     if "iter" in res else None)
    rows.append(_k1_row("fit", fit_launches, err1, ms1, plain1, b1, by1,
                        None, linear_ms=lin_ms, linear_library_ms=mm_ms,
                        library_fn="torch.matmul(X, Z.T) against the "
                                   "linear kind",
                        iter_falkon_launches=iter_launches))
    # a predict batch, and the iterative paths' shapes: EigenPro's
    # mini-batch and the streaming tile (phase iter)
    it = res.get("iter", {})
    for label, rows_n, launches, reps in [
            ("predict", PREDICT_BATCH, predict_launches, 100),
            ("eigenpro batch", 2048, it.get("b", {}).get("batch_launches"),
             50),
            ("streaming tile", 4096, it.get("c", {}).get("tile_launches"),
             50)]:
        rows.append(_k1_shape_row(label, X[:rows_n], Z, launches, reps))
    # W = k(Z, Z) of the sparse path
    _, Zs = _full_chunk(keep)
    Zs = keep.get("sparse_Z", Zs).contiguous()
    ps, ds = Zs.shape
    acc = torch.float64
    Z64 = Zs.double()
    W = kernel_block(Zs, Zs, kind="rbf", bandwidth=RCV1_BANDWIDTH,
                     acc_dtype=acc)
    errw = float((W - ref.rbf_block_ref(Z64, Z64, RCV1_BANDWIDTH).float())
                 .abs().max())
    del W
    msw = cuda_ms(lambda: kernel_block(Zs, Zs, kind="rbf",
                                       bandwidth=RCV1_BANDWIDTH,
                                       acc_dtype=acc), reps=10)
    plainw = cuda_ms(lambda: ref.rbf_block_ref(
        Zs.double(), Zs.double(), RCV1_BANDWIDTH).float(), reps=3)
    libw = cuda_ms(lambda: torch.matmul(Z64, Z64.T), reps=10)
    bw, byw = _k1_bound(ps, ps, ds, "float64")
    bw_work, byw_work, work_share, mma_share = _k1_w_bound(Zs)
    log(f"[summary] K1 rbf W (n,p,d)=({ps},{ps},{ds}) f32 data / f64 "
        f"accumulation (FP64 tensor cores): kernel {msw:.3f} ms, plain "
        f"{plainw:.3f} ms, torch.matmul on float64 copies {libw:.3f} ms, "
        f"bound {bw:.3f} ms ({byw}, dense); bound of the work Z needs "
        f"({100 * work_share:.2f} % of the dense products) {bw_work:.3f} ms "
        f"({byw_work}); the warp steps that run are "
        f"{100 * mma_share:.1f} % of the dense products; max|Δ| "
        f"{errw:.3e}, launches on the sparse path "
        f"{_launches(res, 'sparse', 'kernel_block')}")
    check(errw <= K1_TOL["float32"], f"K1 W: {errw:.3e}")
    res["k1_w_timing"] = dict(kernel=msw, matmul_f64=libw)
    # bound_ms counts the work this Z needs; the dense count beside, and
    # the share of the dense products that the kernel's warp steps run
    rows.append(_k1_row("W", _launches(res, "sparse", "kernel_block"), errw,
                        msw, plainw, bw_work, byw_work, libw,
                        library_fn="torch.matmul on float64 copies",
                        dense_bound_ms=bw, dense_bound_by=byw,
                        work_share=work_share, mma_share=mma_share))
    return rows


def _summary_k2(res: dict) -> dict:
    """K2's row at the main path's shape (n, p) = (463,715, 2048), float32.
    B well conditioned, so the check measures the kernel and not the
    float32 conditioning of the problem. The bound is that of the design
    that runs, 3xTF32 (three TF32 products per multiply-add); the IEEE
    float32 bound of the same function stands beside it."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rls_scores import rls_scores_fused
    n, p = N_TRAIN, P
    C, M = _scores_problem(n, p, torch.float32,
                           torch.Generator(device="cuda").manual_seed(4))
    Mf = M.float()
    s = rls_scores_fused(C, M)
    want = ref.rls_scores_ref(C, Mf)
    err2 = float((s - want).abs().max())
    rel2 = float(((s - want).abs() / want.abs()).max())
    ms2 = cuda_ms(lambda: rls_scores_fused(C, M), reps=3)
    plain2 = cuda_ms(lambda: ref.rls_scores_ref(C, Mf), reps=3)
    lib2 = cuda_ms(lambda: torch.einsum("ij,jk,ik->i", C, Mf, C), reps=3)
    nbytes = 4 * (n * p + p * p + n)
    b2, by2 = _bound_ms(3 * 2 * n * p * p + 2 * n * p, nbytes, "tf32")
    ieee2, _ = _bound_ms(2 * n * p * p + 2 * n * p, nbytes, "float32")
    log(f"[summary] K2 (n,p)=({n},{p}) f32: kernel {ms2:.3f} ms, plain "
        f"{plain2:.3f} ms, einsum {lib2:.3f} ms, bound {b2:.3f} ms ({by2}, "
        f"3xTF32 at the TF32 tensor-core peak; IEEE float32 bound "
        f"{ieee2:.3f} ms), max|Δ| {err2:.3e}, max rel Δ {rel2:.3e} (rtol "
        f"{K2_RTOL['float32']:g})")
    check(rel2 <= K2_RTOL["float32"], f"K2 at main shape: {rel2:.3e}")
    res["k2_timing"] = dict(max_rel_err=rel2, ieee_f32_bound_ms=ieee2)
    return dict(name="rls_scores", route="cuda",
                source="src/repro_torch/kernels/csrc/rls_scores.cu",
                replaces="src/repro/kernels/rls_scores.py:37",
                launches=_launches(res, "main", "rls_scores"),
                max_abs_err=err2, ms=ms2, plain_ms=plain2, bound_ms=b2,
                bound_by=by2, library_ms=lib2, ieee_f32_bound_ms=ieee2)


def _summary_sparse(res: dict, keep: dict) -> dict:
    """K3's row: the build the sparse path runs (float32 data, float64
    accumulation) at one full chunk of the cell against the fitted
    landmarks, prepared once as the path prepares them (the score pass's
    and the solver's launches), and at the whole test set (predict); the
    float32 build and the library call beside it. Two bounds: the dense
    count (2·nnz·p + 5·rows·p operations, as the earlier design did the
    work) and the work that meets a non-zero of Z (2·Σ_c nnz_X(c)·nnz_Z(c)
    + 5·rows·p), each against the bytes."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.sparse_block import (prepare_landmarks,
                                                  sparse_cross)
    X, Z = _full_chunk(keep)
    Z = keep.get("sparse_Z", Z).contiguous()
    rows, p, d = X.shape[0], Z.shape[0], RCV1_DIM
    nnz = int(X.indptr[-1])
    acc = torch.float64       # SPARSE_PRECISION's accumulation
    args = (X.data, X.indices, X.indptr, Z)
    rbf = dict(kind="rbf", bandwidth=RCV1_BANDWIDTH)
    prep_ms = cuda_ms(lambda: prepare_landmarks(Z, acc), reps=3)
    prep = prepare_landmarks(Z, acc)
    prep32 = prepare_landmarks(Z, torch.float32)
    log(f"[summary] K3 landmarks prepared once per fit in {prep_ms:.3f} ms; "
        f"{_k3_split(X, prep)}")
    got = sparse_cross(*args, acc_dtype=acc, prepared=prep, **rbf)
    want = ref.sparse_kernel_block_ref(X.data.to(acc), X.indices, X.indptr,
                                       Z.to(acc), **rbf).float()
    err3 = float((got - want).abs().max())
    del got, want
    ms3 = cuda_ms(lambda: sparse_cross(*args, acc_dtype=acc, prepared=prep,
                                       **rbf), reps=10)
    plain3 = cuda_ms(lambda: ref.sparse_kernel_block_ref(
        X.data.to(acc), X.indices, X.indptr, Z.to(acc), **rbf).float(),
        reps=3)
    ms3_f32 = cuda_ms(lambda: sparse_cross(*args, prepared=prep32, **rbf),
                      reps=10)
    lin3 = cuda_ms(lambda: sparse_cross(*args, kind="linear",
                                        prepared=prep32), reps=10)
    A = torch.sparse_csr_tensor(X.indptr, X.indices[:nnz], X.data[:nnz],
                                size=(rows, d), check_invariants=False)
    Zt = Z.T.contiguous()
    lib3 = cuda_ms(lambda: torch.sparse.mm(A, Zt), reps=10)
    lib_err = float((torch.sparse.mm(A, Zt)
                     - sparse_cross(*args, kind="linear", prepared=prep32))
                    .abs().max())
    T = _rcv1(keep)["test"].cast(torch.float32, "cuda")
    test_ms = cuda_ms(lambda: sparse_cross(T.data, T.indices, T.indptr, Z,
                                           acc_dtype=acc, prepared=prep,
                                           **rbf), reps=10)
    work, _ = _k3_work(X, Z)
    prep_bytes = sum(t.numel() * t.element_size() for t in (
        prep.zz, prep.hot_slot, prep.hot, prep.colptr, prep.ent_j,
        prep.ent_z))
    nbytes = 8 * nnz + 4 * (rows + 1) + 4 * rows * p
    b3, by3 = _bound_ms(2 * nnz * p + 5 * rows * p, nbytes + 4 * d * p,
                        "float64")
    bw3, byw3 = _bound_ms(2 * work + 5 * rows * p, nbytes + prep_bytes,
                          "float64")
    log(f"[summary] K3 rbf full chunk (rows,p,d)=({rows},{p},{d}), {nnz} "
        f"values, f32 data / f64 accumulation: kernel {ms3:.3f} ms, plain "
        f"{plain3:.3f} ms, bound {b3:.3f} ms ({by3}, dense count); bound "
        f"of the work that meets a non-zero of Z "
        f"({100 * work / (nnz * p):.2f} % of nnz·p) {bw3:.3f} ms ({byw3}); "
        f"max|Δ| {err3:.3e}")
    log(f"[summary] K3 rbf same chunk, f32 build: kernel {ms3_f32:.3f} ms")
    log(f"[summary] K3 linear same chunk, f32: kernel {lin3:.3f} ms, "
        f"torch.sparse.mm (cuSPARSE SpMM, f32) {lib3:.3f} ms, max|Δ| "
        f"between them {lib_err:.3e}")
    log(f"[summary] K3 rbf whole test set ({T.shape[0]} rows, "
        f"{int(T.indptr[-1])} values), f32 data / f64 accumulation: "
        f"{test_ms:.3f} ms")
    check(err3 <= K3_TOL["float32"], f"K3 at full chunk: {err3:.3e}")
    res["k3_timing"] = dict(full_chunk_ms=ms3, full_chunk_f32_ms=ms3_f32,
                            linear_f32_ms=lin3, prepare_ms=prep_ms,
                            sparse_mm_ms=lib3, test_set_ms=test_ms,
                            nnz=nnz, rows=rows, work=work)
    return dict(name="sparse_cross", route="cuda",
                source="src/repro_torch/kernels/csrc/sparse_cross.cu",
                replaces="src/repro/kernels/sparse_block.py:149",
                launches=_launches(res, "sparse", "sparse_cross"),
                # phase iter (d): falkon_pcg out of core
                iter_falkon_launches=res.get("iter", {}).get("d", {}).get(
                    "fit_launches", {}).get("sparse_cross"),
                max_abs_err=err3, ms=ms3, plain_ms=plain3, bound_ms=bw3,
                bound_by=byw3, library_ms=lib3,
                # bound_ms counts the work this chunk's data needs; the
                # dense count stands beside it
                dense_bound_ms=b3, dense_bound_by=by3,
                # library_ms times the linear kind in float32, which K3
                # computes in library_kernel_ms
                library_fn="linear, float32", library_kernel_ms=lin3)


def _k4_shape_row(tag: str, cfg, launches, seed: int) -> dict:
    """K4's row at a prefill's shape (1 x LM_SEQ of ``cfg``'s attention,
    bfloat16, causal), beside its plain version and PyTorch's
    scaled_dot_product_attention on the same tensors."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    B, Hq, Hkv, S, D = (1, cfg.n_heads, cfg.n_kv_heads, LM_SEQ,
                        cfg.resolved_head_dim)
    q, k, v = _k4_inputs((B, Hq, S, D), Hkv, torch.bfloat16, seed=seed)
    err, share = _k4_check(q, k, v, True, 0)
    ms = cuda_ms(lambda: flash_attention(q, k, v), reps=10)
    plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v), reps=3)
    try:
        def lib():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        lib()
        lib_fn = "scaled_dot_product_attention(is_causal, enable_gqa)"
    except TypeError:     # a torch without enable_gqa: K/V expanded
        kx = k.repeat_interleave(Hq // Hkv, dim=1)
        vx = v.repeat_interleave(Hq // Hkv, dim=1)

        def lib():
            return F.scaled_dot_product_attention(q, kx, vx, is_causal=True)
        lib_fn = "scaled_dot_product_attention(is_causal), K/V expanded"
    lib_ms = cuda_ms(lib, reps=10)
    lib_err = float((lib().float() - flash_attention(q, k, v).float())
                    .abs().max())
    pairs = B * Hq * S * (S + 1) // 2          # causal live (query, key)
    bound, by = _bound_ms(4 * D * pairs, 2 * (2 * B * Hq + 2 * B * Hkv) * S
                          * D, "bfloat16")
    log(f"[summary] K4 {tag} (B,Hq,Hkv,S,D)=({B},{Hq},{Hkv},{S},{D}) bf16 "
        f"causal: kernel {ms:.3f} ms, plain {plain:.3f} ms, {lib_fn} "
        f"{lib_ms:.3f} ms (max|Δ| to K4 {lib_err:.3e}), bound {bound:.3f} ms "
        f"({by}, {4 * D * pairs / 1e9:.1f} GFLOP at the bf16 tensor-core "
        f"peak), {4 * D * pairs / ms / 1e9:.1f} TFLOP/s, max|Δ| {err:.3e} "
        f"({share:.3f} of the tolerance); launches {launches}")
    return dict(name="flash_attention", shape=f"{tag} (B, Hq, Hkv, S, D) = "
                f"{(B, Hq, Hkv, S, D)} bf16 causal", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:97",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib_ms,
                library_fn=lib_fn, library_max_abs_diff=lib_err,
                tflops=4 * D * pairs / ms / 1e9)


def _summary_attention(res: dict) -> dict:
    """K4's row at the phi4-mini prefill's shape (phase lm)."""
    row = _k4_shape_row(LM_ARCH, _lm_config(),
                        _launches(res, "lm", "flash_attention"), seed=8)
    res["k4_timing"] = dict(library_fn=row["library_fn"],
                            library_max_abs_diff=row["library_max_abs_diff"],
                            tflops=row["tflops"])
    return row


def _summary_families(res: dict) -> list[dict]:
    """K4's rows at the prefill shapes of phase families' attention cells,
    each with its launches in that cell's measured prefill."""
    fam = res["families"]
    return [_k4_shape_row(arch, _family_config(arch),
                          fam[key]["launches"]["flash_attention"], seed=seed)
            for arch, key, seed in ((ZAMBA_ARCH, "hybrid", 9),
                                    (MOE_ARCH, "moe", 10),
                                    (AUDIO_ARCH, "audio", 11))]


def _summary_train_attention(res: dict) -> dict:
    """K4's row at the training shape of phase train (a), from (b)'s
    measurements, with its launches in (a)'s steps and the backward
    through the plain version beside it."""
    tr = res["train"]
    k = tr["k4"]
    launches = sum(r["k4_launches"] for r in tr["steps"])
    log(f"[summary] K4 training shape {tuple(k['shape'])} bf16 causal: "
        f"kernel {k['ms']:.3f} ms, plain {k['plain_ms']:.3f} ms, SDPA "
        f"{k['library_ms']:.3f} ms, bound {k['bound_ms']:.3f} ms "
        f"({k['bound_by']}); {tr['k4_launches_per_step']} launches a step, "
        f"{launches} in (a); backward {k['backward_ms']:.3f} ms a layer "
        f"(SDPA's {k['library_backward_ms']:.3f} ms)")
    return dict(name="flash_attention", shape="train (B, Hq, Hkv, S, D) = "
                f"{tuple(k['shape'])} bf16 causal", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:97",
                launches=launches, max_abs_err=k["max_abs_err"], ms=k["ms"],
                plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                bound_by=k["bound_by"], library_ms=k["library_ms"],
                library_fn="scaled_dot_product_attention(is_causal), K/V "
                "expanded", launches_per_train_step=tr["k4_launches_per_step"],
                backward_ms=k["backward_ms"],
                library_backward_ms=k["library_backward_ms"])


def _summary_train_families(res: dict) -> list[dict]:
    """K4's rows at the training shapes of phase train_families' attention
    cells, each with its launches in that cell's TRAIN_STEPS steps."""
    tf = res["train_families"]
    rows = []
    for arch, k in tf["k4"].items():
        cell = tf["cells"][arch]
        launches = sum(r["k4_launches"] for r in cell["steps"])
        rows.append(dict(
            name="flash_attention", shape=f"train {arch} (B, Hq, Hkv, S, D) "
            f"= {tuple(k['shape'])} bf16 causal", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:97",
            launches=launches, max_abs_err=k["max_abs_err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            library_fn="scaled_dot_product_attention(is_causal), K/V "
            "expanded", launches_per_train_step=cell["k4_launches_per_step"]))
        log(f"[summary] K4 training shape of {arch} {tuple(k['shape'])}: "
            f"kernel {k['ms']:.3f} ms, plain {k['plain_ms']:.3f} ms, SDPA "
            f"{k['library_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}); {cell['k4_launches_per_step']} launches a "
            f"step, {launches} in the cell")
    return rows


def phase_summary(res: dict, keep: dict) -> None:
    """The kernel rows of the paths this run drove."""
    rows = []
    for name in ("kernel_block", "sparse_cross"):
        for line in res.get("ptxas", {}).get(name, []):
            log(f"[summary] ptxas {name}: {line}")
    if "Xtr" in keep or "k1" in keep or "iter" in res:
        rows.extend(_summary_k1(res, keep))
    if "Xtr" in keep or "k2" in keep:
        rows.append(_summary_k2(res))
    if "rcv1" in keep:
        rows.append(_summary_sparse(res, keep))
    if "lm" in keep or "k4" in keep:
        rows.append(_summary_attention(res))
    if "train" in keep:
        rows.append(_summary_train_attention(res))
    if "train_families" in keep:
        rows.extend(_summary_train_families(res))
    if "families" in keep:
        rows.extend(_summary_families(res))
    if "samplers" in res or "serve" in res:
        rows.extend(_summary_slice7(res, keep))
    if "bf16" in res:
        rows.extend(_summary_bf16(res, keep))
    res["kernels"] = rows


def phase_limits(res: dict, keep: dict) -> None:
    """K2's 3xTF32 build launched through the library's entry point at
    p = 2048, 4096 and 8192 (n = 5003), where the wrapper refuses
    p > TF32X3_MAX_P, and K1's linear kind against torch.matmul at the
    fit's n and p with d = 16 and 256 (random rows): the growth with d is
    the products' rate."""
    import torch
    from repro_torch.kernels import ref, rls_scores
    from repro_torch.kernels.rbf_block import kernel_block
    g = torch.Generator(device="cuda").manual_seed(2)
    fn, err = rls_scores._entry()
    for p in (2048, 4096, 8192):
        n = 5003
        B, M = _scores_problem(n, p, torch.float32, g)
        got = torch.empty(n, dtype=torch.float32, device="cuda")
        Mf = M.float().contiguous()
        code = fn(B.data_ptr(), Mf.data_ptr(), got.data_ptr(), n, p, 0, 0,
                  B.device.index, torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"k2 entry point: {err(code).decode()}")
        want = ref.rls_scores_ref(B, Mf)
        rel = float(((got - want).abs() / want.abs()).max())
        log(f"[limits] K2 3xTF32 (n,p)=({n},{p}) max rel Δ={rel:.3e} "
            f"({K2_RTOL['float32'] / rel:.1f}x inside rtol "
            f"{K2_RTOL['float32']:g})")
        res.setdefault("k2_tf32x3_rel_err_by_p", {})[str(p)] = rel
    n, p = N_TRAIN, P
    g = torch.Generator(device="cuda").manual_seed(9)
    sweep = {}
    for dd in (16, 256):
        Xd = torch.randn(n, dd, generator=g, device="cuda")
        Zd = torch.randn(p, dd, generator=g, device="cuda")
        sweep[dd] = (cuda_ms(lambda: kernel_block(Xd, Zd, kind="linear"),
                             reps=5),
                     cuda_ms(lambda: torch.matmul(Xd, Zd.T), reps=5))
        del Xd, Zd
    rate = {who: 2 * n * p * 240 / ((sweep[256][i] - sweep[16][i]) * 1e-3)
            for i, who in enumerate(("kernel", "matmul"))}
    log(f"[limits] K1 linear (n,p)=({n},{p}) at d = 16 / 256: kernel "
        f"{sweep[16][0]:.3f} / {sweep[256][0]:.3f} ms, torch.matmul "
        f"{sweep[16][1]:.3f} / {sweep[256][1]:.3f} ms; products between them "
        f"at {rate['kernel'] / 1e12:.1f} / {rate['matmul'] / 1e12:.1f} "
        f"TFLOP/s ({100 * rate['kernel'] / PEAK_OPS['float32']:.0f} / "
        f"{100 * rate['matmul'] / PEAK_OPS['float32']:.0f} % of the float32 "
        f"peak)")
    res["k1_d_sweep_ms"] = {str(k): v for k, v in sweep.items()}
    # K2's bf16 build through the wrapper, which does not limit p there:
    # its scores against float64 scores, and its share of the bf16
    # tolerance against the plain version
    g = torch.Generator(device="cuda").manual_seed(2)
    for p in (2048, 4096, 8192):
        n = 5003
        B, M = _scores_problem(n, p, torch.bfloat16, g)
        got = rls_scores.rls_scores_fused(B, M)
        exact = ref.rls_scores_ref(B.double(), M)
        rel = float(((got.double() - exact).abs() / exact.abs()).max())
        _, share = _bf16_share(got, ref.rls_scores_ref(
            B.float(), M.float()).to(torch.bfloat16),
            BF16_STEP + K2_RTOL["float32"], 1e-6)
        log(f"[limits] K2 bf16 (2xTF32) (n,p)=({n},{p}): max rel Δ from "
            f"float64 scores {rel:.3e} (a bf16 step is {BF16_STEP:.3e}); "
            f"{share:.3f} of the bf16 tolerance against the plain version")
        check(share <= 1.0, f"K2 bf16 at p={p}: {share:.3f} of tolerance")
        res.setdefault("k2_bf16_by_p", {})[str(p)] = dict(
            rel_to_float64=rel, tolerance_share=share)


# -------------------------------------------------------------------- main

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {PHASES + OPT_IN}")
    phases = parser.parse_args().phases.split(",")
    unknown = set(phases) - set(PHASES + OPT_IN)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; chip_smoke needs "
              "one CUDA GPU", flush=True)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.api  # noqa: F401
    except ImportError as exc:
        print(f"FAIL: cannot import repro_torch from {ROOT / 'src'}: {exc}",
              flush=True)
        return 1
    from repro_torch.device import resolve_device
    resolve_device("cuda")   # IEEE float32 matmuls for the plain versions

    res: dict = {"device_name": torch.cuda.get_device_name(0),
                 "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"[start] {res['device_name']} x{torch.cuda.device_count()}, torch "
        f"{res['torch']}, CUDA {res['cuda']}")
    keep: dict = {}
    t_all = time.perf_counter()
    for name in PHASES + OPT_IN:
        if name not in phases:
            continue
        t0 = time.perf_counter()
        if name == "build":
            phase_build(res)
        elif name == "k1":
            phase_k1(res, keep)
        elif name == "k2":
            phase_k2(res, keep)
        elif name == "k3":
            phase_k3(res, keep)
        elif name == "k4":
            phase_k4(res, keep)
        elif name == "main":
            phase_main(res, keep)
        elif name == "parity":
            phase_parity(res, keep)
        elif name == "sparse":
            phase_sparse(res, keep)
        elif name == "iter":
            phase_iter(res, keep)
        elif name == "samplers":
            phase_samplers(res, keep)
        elif name == "serve":
            phase_serve(res, keep)
        elif name == "bf16":
            phase_bf16(res, keep)
        elif name == "lm":
            phase_lm(res, keep)
        elif name == "train":
            phase_train(res, keep)
        elif name == "train_families":
            phase_train_families(res, keep)
        elif name == "families":
            phase_families(res, keep)
        elif name == "rls":
            phase_rls(res, keep)
        elif name == "summary":
            phase_summary(res, keep)
        elif name == "limits":
            phase_limits(res, keep)
        log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    res["total_s"] = time.perf_counter() - t_all
    if "card" not in res:
        res["card"] = card_line()
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(res, indent=1))
    print(res["card"], flush=True)
    if res.get("kernels"):
        print(json.dumps({"kernels": res["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
