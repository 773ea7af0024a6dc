"""The port's training runtime on the CPU: checkpoints, the fault-tolerant
driver, the LM token stream, gradient compression's error feedback and the
training launcher, mirroring tests/test_fault_tolerance.py (which holds the
JAX package to the same properties).

The driver's restart runs the port's own train step on a tiny phi4-mini
(2 layers, d_model 64, vocab 256, float32, through K4's plain version) and
must reproduce the uninterrupted run's losses and parameters bit for bit:
the step is deterministic on the CPU and a checkpoint restores float32
exactly. The token stream cannot be compared with the reference's
(threefry draws), so its properties are tested.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

import _torch_common  # noqa: F401  (one thread)
from repro_torch.checkpoint import (all_steps, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.data import LMDataConfig, lm_batch, lm_stream
from repro_torch.launch import train as train_cli
from repro_torch.optim import AdamWState, compressed_grads, init_compression
from repro_torch.runtime import (DriverConfig, StepFailure, StragglerStats,
                                 TrainDriver)


# ---------------------------------------------------------- checkpoints

def test_checkpoint_round_trip_keeps_every_bit(tmp_path):
    """float32, bfloat16 (saved as its bit patterns), int32 and a named
    tuple come back equal, in ``like``'s dtypes, with the reference's
    manifest."""
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(10, generator=g),
            "b": [{"c": torch.randn(3, 4, generator=g).bfloat16()}],
            "opt": AdamWState(torch.tensor(7, dtype=torch.int32),
                              torch.ones(2), torch.zeros(2))}
    path = save_checkpoint(str(tmp_path), 5, tree, metadata={"arch": "x"})
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(path)) == ["manifest.json", "shard_0.npz"]
    manifest = json.loads((tmp_path / "step_00000005" /
                           "manifest.json").read_text())
    assert manifest["n_leaves"] == 5 and manifest["metadata"] == {"arch": "x"}
    assert "bfloat16" in manifest["dtypes"] and "int32" in manifest["dtypes"]
    like = {"a": torch.zeros(10), "b": [{"c": torch.zeros(3, 4).bfloat16()}],
            "opt": AdamWState(torch.tensor(0, dtype=torch.int32),
                              torch.zeros(2), torch.ones(2))}
    got = restore_checkpoint(str(tmp_path), 5, like)
    assert isinstance(got["opt"], AdamWState)
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_retention(tmp_path):
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(str(tmp_path), s, {"x": torch.zeros(3)}, keep=2)
    assert all_steps(str(tmp_path)) == [4, 5]


def test_incomplete_checkpoint_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(3)})
    # a crash mid-save: a directory without a manifest, a staging directory
    os.makedirs(tmp_path / "step_00000002")
    os.makedirs(tmp_path / "step_00000003.tmp")
    assert latest_step(str(tmp_path)) == 1


def test_restore_refuses_another_structure(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="1 leaves"):
        restore_checkpoint(str(tmp_path), 1, {"x": torch.zeros(3),
                                              "y": torch.zeros(1)})


# --------------------------------------------------------------- driver

def test_failure_restores_and_completes(tmp_path):
    """Failures injected at steps 7 and 12: the driver restores the last
    checkpoint and still produces the no-failure trajectory."""
    def make(fail_at):
        fails = set(fail_at)

        def step_fn(state, batch):
            w = state["w"] + batch["x"].mean()
            return {"w": w}, {"w0": w[0]}

        def fault_hook(s):
            if s in fails:
                fails.remove(s)
                raise StepFailure(f"injected at {s}")

        return TrainDriver(
            DriverConfig(total_steps=15, ckpt_dir=str(tmp_path / str(
                bool(fail_at))), ckpt_every=5),
            step_fn, {"w": torch.zeros(4)},
            lambda s: {"x": torch.full((4,), float(s))},
            fault_hook=fault_hook)

    clean, faulty = make([]), make([7, 12])
    want, got = clean.run(), faulty.run()
    assert faulty.restarts == 2
    assert torch.equal(got["w"], want["w"])


_BUILD_SMALL_CFG = train_cli.build_small_cfg


def _tiny_cfg(arch: str, **over):
    """build_small_cfg cut to 2 layers of width 64 and a vocab of 256."""
    return _BUILD_SMALL_CFG(
        arch, **dict(dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          use_pallas=True), **over))


def _tiny_driver(tmp_path, name, fail_at=()):
    cfg = _tiny_cfg("phi4-mini-3.8b")
    fails = set(fail_at)

    def fault_hook(step):
        if step in fails:
            fails.remove(step)
            raise StepFailure(f"injected at {step}")

    return train_cli.make_driver(
        cfg, steps=8, batch=2, seq=32, lr=3e-3, ckpt_dir=str(tmp_path / name),
        ckpt_every=3, device="cpu", fault_hook=fault_hook)


def test_train_step_restart_reproduces_the_clean_losses(tmp_path):
    """The launcher's driver over the port's train step: a failure at
    step 5 restores step 3 and replays; the losses and the final
    parameters equal the uninterrupted run's bit for bit."""
    clean = _tiny_driver(tmp_path, "clean")
    want = clean.run()
    faulty = _tiny_driver(tmp_path, "faulty", fail_at=[5])
    got = faulty.run()
    assert faulty.restarts == 1
    losses = [m["loss"] for m in clean.metrics_log]
    replay = [m["loss"] for m in faulty.metrics_log]
    assert len(losses) == 8 and len(replay) == 10
    assert replay[:5] == losses[:5] and replay[5:] == losses[3:]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))
    assert all_steps(str(tmp_path / "faulty")) == [3, 6, 8]


def test_exceeding_max_restarts_raises(tmp_path):
    def fault_hook(s):
        raise StepFailure("always")

    drv = TrainDriver(
        DriverConfig(total_steps=5, ckpt_dir=str(tmp_path), ckpt_every=2,
                     max_restarts=2),
        lambda state, batch: (state, {}), {"w": torch.zeros(2)},
        lambda s: {}, fault_hook=fault_hook)
    with pytest.raises(StepFailure):
        drv.run()
    assert drv.restarts == 3


def test_detects_slow_steps():
    st = StragglerStats(factor=3.0)
    for _ in range(10):
        st.observe(0.1)
    assert st.observe(1.0) is True
    assert st.slow_steps == 1
    # a slow sample must not poison the EWMA
    assert st.ewma < 0.2


# --------------------------------------------------------- token stream

def test_batch_is_a_pure_function_of_the_step():
    cfg = LMDataConfig(vocab_size=1000, seq_len=32, global_batch=4)
    b1, b2, b3 = lm_batch(cfg, 7), lm_batch(cfg, 7), lm_batch(cfg, 8)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].shape == b1["labels"].shape == (4, 32)
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 1000
    other = lm_batch(dataclasses.replace(cfg, seed=1), 7)
    assert not torch.equal(b1["tokens"], other["tokens"])


def test_host_slices_agree_with_the_whole_batch():
    cfg = LMDataConfig(vocab_size=1000, seq_len=16, global_batch=8)
    full = lm_batch(cfg, 3)
    part = lm_batch(cfg, 3, host_slice=slice(2, 6))
    assert torch.equal(full["tokens"][2:6], part["tokens"])
    stream = lm_stream(cfg, start_step=3)
    assert torch.equal(next(stream)["tokens"], full["tokens"])
    assert torch.equal(next(stream)["tokens"], lm_batch(cfg, 4)["tokens"])


# ---------------------------------------------------------- compression

def test_error_feedback_preserves_signal():
    """Int8 + error feedback: the accumulated compressed gradients track
    the accumulated true gradients (the error does not grow)."""
    g = torch.Generator().manual_seed(0)
    state = init_compression({"w": torch.zeros(64, 64)})
    acc_true = torch.zeros(64, 64)
    acc_comp = torch.zeros(64, 64)
    for _ in range(20):
        gs = {"w": torch.randn(64, 64, generator=g)}
        comp, state = compressed_grads(gs, state)
        acc_true += gs["w"]
        acc_comp += comp["w"]
    assert float(torch.linalg.norm(acc_comp - acc_true)
                 / torch.linalg.norm(acc_true)) < 0.02


def test_quantization_error_is_half_a_step():
    w = torch.randn(128, generator=torch.Generator().manual_seed(0))
    comp, _ = compressed_grads({"w": w}, init_compression({"w": w}))
    scale = float(w.abs().max()) / 127.0
    assert float((comp["w"] - w).abs().max()) <= scale * 0.5 + 1e-6


# ------------------------------------------------------------- launcher

def test_train_cli_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The CLI end to end, its reduced config cut further (``_tiny_cfg``)
    so that the test stays short."""
    monkeypatch.setattr(train_cli, "build_small_cfg", _tiny_cfg)
    driver = train_cli.main([
        "--arch", "phi4-mini-3.8b", "--device", "cpu", "--steps", "1",
        "--batch", "1", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert len(driver.metrics_log) == 1
    assert np.isfinite(driver.metrics_log[0]["loss"])
    assert all_steps(str(tmp_path)) == [1]
    assert "steps=1 first_loss=" in capsys.readouterr().out
