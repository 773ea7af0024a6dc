#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA H100 and hold its kernels to account.

    python3 chip_smoke.py          # from the root of a checkout; one CUDA GPU

Drives ``repro_torch`` (never the JAX package) through six phases and exits
non-zero on any failure:

  1. build     compile the CUDA kernels (``src/repro_torch/kernels/csrc``)
               with nvcc for sm_90a; print the card's name and power limit.
  2. k1        K1 ``kernel_block`` against its plain PyTorch version, rbf /
               linear / poly x {f32, f64} at ragged shapes, and the two
               mixed data/accumulation dtype builds.
  3. k2        K2 ``rls_scores`` against its plain version, {f32, f64} x
               p in {37, 600, 2048}, and the two mixed builds.
  4. main      the paper's fit -> predict path at full size: MSD-shaped data
               (n = 463,715 train, 51,630 test, d = 90) from
               ``pumadyn_like(dim=90, seed=0)``, SketchConfig(RBFKernel(6.0),
               p=2048, lam=1e-6) with the defaults rls_fast / nystrom / auto,
               fit then predict_batched(batch_size=256); launch counts are
               zeroed just before and read just after.
  5. parity    the same fit at n = 20,000 through backend "hopper" and
               backend "torch" on the card, with the same draws injected.
  6. summary   each kernel's time at the main path's shapes (CUDA events),
               its plain version's, the matching PyTorch library call's, and
               its bound; one JSON line of kernels, then the last line
               {"ok": true, "device": {...}}.

``--phases`` runs a subset (for development); the default runs all six.
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
PHASES = ("build", "k1", "k2", "main", "parity", "summary")

# H100 SXM data sheet: float32 on the CUDA cores (IEEE, no tensor cores),
# float64 on the CUDA cores, HBM3 bandwidth
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12

N_TRAIN, N_TEST, DIM = 463_715, 51_630, 90
P, LAM, BANDWIDTH = 2048, 1e-6, 6.0
N_PARITY = 20_000

K1_TOL = {"float32": 2e-5, "float64": 1e-12}      # atol on blocks
K2_RTOL = {"float32": 2e-4, "float64": 1e-12}     # elementwise rtol on scores
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
    for path in libs.values():
        logfile = path.with_suffix(".log")
        if logfile.exists():
            for line in logfile.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {path.stem.split('-')[0]}: {line.strip()}")
    res["card"] = card_line()
    log(f"[build] card (nvidia-smi name, power.limit): {res['card']}")


def phase_k1(res: dict) -> None:
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
    res["k1_check_max_abs_err"] = worst


def _scores_problem(n: int, p: int, dtype, g):
    import torch
    B = torch.randn(n, p, generator=g, device="cuda",
                    dtype=torch.float64) / p ** 0.5
    A = B.T @ B + n * 1e-3 * torch.eye(p, device="cuda", dtype=torch.float64)
    M = torch.cholesky_inverse(torch.linalg.cholesky(A))
    return B.to(dtype), M


def phase_k2(res: dict) -> None:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rls_scores import rls_scores_fused
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for p in (37, 600, 2048):
        for dtype in (torch.float32, torch.float64):
            n = 5003
            B, M = _scores_problem(n, p, dtype, g)
            got = rls_scores_fused(B, M)
            want = ref.rls_scores_ref(B, M.to(dtype))
            torch.cuda.synchronize()
            name = str(dtype).removeprefix("torch.")
            rel = float(((got - want).abs() / want.abs()).max())
            tol = K2_RTOL[name]
            log(f"[k2] {name} (n,p)=({n},{p}) max rel Δ={rel:.3e} "
                f"(rtol {tol:g}), scores in [{float(want.min()):.3g}, "
                f"{float(want.max()):.3g}]")
            check(got.dtype == dtype and got.shape == (n,),
                  f"k2 {name} returned {got.dtype} {got.shape}")
            check(rel <= tol, f"k2 {name} p={p}: max rel Δ {rel:.3e} > {tol:g}")
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


def _msd_data():
    import numpy as np
    from repro_torch.data import pumadyn_like
    data = pumadyn_like(N_TRAIN + N_TEST, dim=DIM, seed=0)
    X = data["x"].astype(np.float32)
    y = data["y"].astype(np.float32)
    f = data["f_star"].astype(np.float32)
    return (X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], f[N_TRAIN:])


def phase_main(res: dict, keep: dict) -> None:
    import torch
    from repro_torch.api import RBFKernel, SketchConfig, SketchedKRR
    from repro_torch.kernels import ops as kops
    t0 = time.perf_counter()
    Xtr, ytr, Xte, fte = _msd_data()
    log(f"[main] data {Xtr.shape} train, {Xte.shape} test (d={DIM}) made "
        f"in {time.perf_counter() - t0:.1f} s")
    cfg = SketchConfig(RBFKernel(BANDWIDTH), p=P, lam=LAM)
    model = SketchedKRR(cfg)
    log(f"[main] {model!r}, backend -> {model.ops().name}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    peak = torch.cuda.max_memory_allocated()
    f = torch.as_tensor(fte, device="cuda")
    mse = float(torch.mean((yhat - f) ** 2))
    var_f = float(torch.var(f))
    state = model.state()
    log(f"[main] fit {fit_s:.2f} s (launches {fit_counts}); predict_batched "
        f"{pred_s:.2f} s = {N_TEST / pred_s:.0f} predictions/s; launches "
        f"after predict {counts}")
    log(f"[main] peak device memory {peak / 1e9:.2f} GB; test MSE vs f* "
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
                       peak_bytes=peak, test_mse=mse, var_f_star=var_f,
                       launches=counts, fit_launches=fit_counts)
    prof = _profile(model, Xtr, ytr, Xte)
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
    keep.update(Xtr=Xtr, ytr=ytr, Xte=Xte, Z=state.landmarks)


def phase_parity(res: dict, keep: dict) -> None:
    import torch
    from repro_torch.api import RBFKernel, SketchConfig, SketchedKRR
    from repro_torch.core.leverage import draw_landmarks
    Xtr, ytr, Xte = keep["Xtr"][:N_PARITY], keep["ytr"][:N_PARITY], \
        keep["Xte"][:4096]
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


def _profile(model, Xtr, ytr, Xte) -> dict:
    """Device time by kernel over one more fit + predict_batched, under
    ``torch.profiler`` (CUPTI), and the device's busy share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.fit(Xtr, ytr)
        model.predict_batched(Xte, batch_size=256)
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
                kernels=[dict(name=k[:90], device_us=us, calls=c)
                         for k, us, c in rows[:15]])


def _bound_ms(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_summary(res: dict, keep: dict) -> None:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rbf_block import kernel_block
    from repro_torch.kernels.rls_scores import rls_scores_fused
    launches = res.get("main", {}).get("launches", {})
    X = torch.as_tensor(keep["Xtr"], device="cuda")
    Z = keep["Z"].contiguous()
    n, d = X.shape
    p = Z.shape[0]

    # K1 at the main path's shape: the score pass's and the solver's columns
    C = kernel_block(X, Z, kind="rbf", bandwidth=BANDWIDTH)
    err1 = float((C - ref.rbf_block_ref(X, Z, BANDWIDTH)).abs().max())
    ms1 = cuda_ms(lambda: kernel_block(X, Z, kind="rbf",
                                       bandwidth=BANDWIDTH), reps=10)
    plain1 = cuda_ms(lambda: ref.rbf_block_ref(X, Z, BANDWIDTH), reps=10)
    b1, by1 = _bound_ms(2 * n * p * d + 2 * (n + p) * d + 5 * n * p,
                        4 * (n * d + p * d + n * p), "float32")
    lin_ms = cuda_ms(lambda: kernel_block(X, Z, kind="linear"), reps=10)
    mm_ms = cuda_ms(lambda: torch.matmul(X, Z.T), reps=10)
    log(f"[summary] K1 rbf (n,p,d)=({n},{p},{d}) f32: kernel {ms1:.3f} ms, "
        f"plain {plain1:.3f} ms, bound {b1:.3f} ms ({by1}), max|Δ| "
        f"{err1:.3e}")
    log(f"[summary] K1 linear same shape: kernel {lin_ms:.3f} ms, "
        f"torch.matmul(X, Z.T) {mm_ms:.3f} ms")

    # K2 at the main path's shape (n, p); B well conditioned, so the check
    # measures the kernel and not the float32 conditioning of the problem
    del C
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
    b2, by2 = _bound_ms(2 * n * p * p + 2 * n * p,
                        4 * (n * p + p * p + n), "float32")
    log(f"[summary] K2 (n,p)=({n},{p}) f32: kernel {ms2:.3f} ms, plain "
        f"{plain2:.3f} ms, einsum {lib2:.3f} ms, bound {b2:.3f} ms ({by2}), "
        f"max|Δ| {err2:.3e}, max rel Δ {rel2:.3e}")
    check(err1 <= K1_TOL["float32"], f"K1 at main shape: {err1:.3e}")
    check(rel2 <= K2_RTOL["float32"], f"K2 at main shape: {rel2:.3e}")

    src = "src/repro_torch/kernels/csrc"
    res["kernels"] = [
        dict(name="kernel_block", route="cuda",
             source=f"{src}/kernel_block.cu",
             replaces="src/repro/kernels/rbf_block.py:84",
             launches=launches.get("kernel_block", 0), max_abs_err=err1,
             ms=ms1, plain_ms=plain1, bound_ms=b1, bound_by=by1,
             library_ms=None),
        dict(name="rls_scores", route="cuda", source=f"{src}/rls_scores.cu",
             replaces="src/repro/kernels/rls_scores.py:37",
             launches=launches.get("rls_scores", 0), max_abs_err=err2,
             ms=ms2, plain_ms=plain2, bound_ms=b2, bound_by=by2,
             library_ms=lib2),
    ]
    res["k1_linear_vs_matmul_ms"] = dict(kernel=lin_ms, matmul=mm_ms)


# -------------------------------------------------------------------- main

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {PHASES}")
    phases = parser.parse_args().phases.split(",")
    unknown = set(phases) - set(PHASES)
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
    for name in PHASES:
        if name not in phases:
            continue
        t0 = time.perf_counter()
        if name == "build":
            phase_build(res)
        elif name == "k1":
            phase_k1(res)
        elif name == "k2":
            phase_k2(res)
        elif name == "main":
            phase_main(res, keep)
        elif name == "parity":
            phase_parity(res, keep)
        elif name == "summary":
            phase_summary(res, keep)
        log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    res["total_s"] = time.perf_counter() - t_all
    if "card" not in res:
        res["card"] = card_line()
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(res, indent=1))
    print(res["card"], flush=True)
    if "kernels" in res:
        print(json.dumps({"kernels": res["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
