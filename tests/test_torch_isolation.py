"""The PyTorch port stands alone, and its kernel wrappers keep the device
rules.

The port never imports JAX or the JAX package. The import check runs in a
subprocess, because tests/conftest.py has already imported JAX into this
one; the source scan covers every module of ``src/repro_torch`` and
``chip_smoke.py``, including imports that only run inside functions.
On the CPU the kernel wrappers never launch a kernel (K4 included); K1-K3
refuse a float16 request for the card before anything is built, while a
bf16 one passes their dtype checks; and a device without a kernel route
raises.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import (flash_attention, ops, rbf_block,
                                 rls_scores, sparse_block)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SCANNED = {"repro_torch": sorted(PORT.glob("*.py")),
           "chip_smoke.py": [ROOT / "chip_smoke.py"]}
SCANNED.update({sub: sorted((PORT / sub).rglob("*.py"))
                for sub in ("api", "core", "data", "kernels", "configs",
                            "models", "serve", "runtime", "launch", "optim",
                            "checkpoint")})


def test_the_scan_covers_every_module_of_the_port():
    """Every source file of the package (new modules and subpackages
    included) is in one of the scanned parts."""
    scanned = {path for paths in SCANNED.values() for path in paths}
    assert set(PORT.rglob("*.py")) <= scanned, \
        sorted(str(p) for p in set(PORT.rglob("*.py")) - scanned)
    assert {PORT / "models" / "moe.py", PORT / "models" / "ssm.py"} <= scanned


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import sys, repro_torch.api, repro_torch.core, "
            "repro_torch.kernels.ops, repro_torch.data, "
            "repro_torch.api.out_of_core, repro_torch.data.chunks, "
            "repro_torch.data.sparse, repro_torch.kernels.sparse_block, "
            "repro_torch.configs, repro_torch.models, repro_torch.serve, "
            "repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.runtime, repro_torch.launch.serve, "
            "repro_torch.core.bless, repro_torch.core.recursive_rls, "
            "repro_torch.core.dnc, repro_torch.core.concentration, "
            "repro_torch.serve.queue, repro_torch.serve.slot, "
            "repro_torch.serve.engine, repro_torch.serve.refresh, "
            "repro_torch.optim, repro_torch.checkpoint, "
            "repro_torch.runtime.train_loop, "
            "repro_torch.runtime.fault_tolerance, repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("part", sorted(SCANNED))
def test_port_sources_never_import_jax_or_the_reference(part):
    assert SCANNED[part], part
    for path in SCANNED[part]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [m for m in names if _forbidden(m)]
            assert not bad, f"{path.name}:{node.lineno} imports {bad}"


# ---------------------------------------------------------- device rules

def test_cpu_tensors_never_launch_a_kernel():
    ops.reset_launch_counts()
    X = torch.randn(40, 5)
    ops.rbf_block(X, X[:8], bandwidth=1.3)
    ops.linear_block(X, X[:8])
    ops.poly_block(X, X[:8], degree=3)
    ops.rls_scores(X, torch.eye(5))
    ops.sparse_block(X.reshape(-1), torch.zeros(200, dtype=torch.int32),
                     torch.arange(0, 201, 5, dtype=torch.int32), X[:8],
                     kind="rbf")
    q = torch.randn(1, 4, 32, 16)
    ops.attention(q, q[:, :2], q[:, :2], window=8)
    assert ops.launch_counts() == {"kernel_block": 0, "rls_scores": 0,
                                   "sparse_cross": 0,
                                   "flash_attention": 0}


class _Built(Exception):
    """Raised by a stand-in for a wrapper's library: the call got past every
    check and asked for its kernel."""


def test_bf16_card_request_raises(monkeypatch):
    """K1-K3 take bf16 since their bf16 instances were ported: a bf16
    request passes the dtype checks and reaches the build, while float16
    (no instance) and a bf16 accumulator are refused before anything is
    built or launched, naming the dtypes that are supported."""
    # pretend the operands passed the device check, and stand in for the
    # libraries, so that reaching one is visible and nothing is compiled
    for mod in (rbf_block, rls_scores, sparse_block):
        monkeypatch.setattr(mod, "check_cuda", lambda *a: None)

        def built():
            raise _Built
        monkeypatch.setattr(mod, "_entry", built)
    ops.reset_launch_counts()
    idx = torch.zeros(4, dtype=torch.int32)
    ptr = torch.tensor([0, 4], dtype=torch.int32)

    def calls(dt, acc=None):
        X = torch.zeros(4, 3, dtype=dt)
        return [lambda: rbf_block.kernel_block(X, X, acc_dtype=acc),
                lambda: rls_scores.rls_scores_fused(X, torch.zeros(3, 3),
                                                    acc_dtype=acc),
                lambda: sparse_block.sparse_cross(
                    torch.zeros(4, dtype=dt), idx, ptr, X,
                    acc_dtype=acc or torch.float32)]

    for call in calls(torch.bfloat16):
        with pytest.raises(_Built):
            call()
    for call in calls(torch.float16):
        with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
            call()
    for call in calls(torch.bfloat16, acc=torch.bfloat16):
        with pytest.raises(TypeError, match="float32 or float64"):
            call()
    assert ops.launch_counts() == {"kernel_block": 0, "rls_scores": 0,
                                   "sparse_cross": 0,
                                   "flash_attention": 0}


def test_wrappers_refuse_cpu_tensors_and_dispatch_refuses_other_devices():
    X = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        rbf_block.kernel_block(X, X)
    with pytest.raises(ValueError, match="CUDA"):
        rls_scores.rls_scores_fused(X, torch.zeros(3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        sparse_block.sparse_cross(torch.zeros(4),
                                  torch.zeros(4, dtype=torch.int32),
                                  torch.tensor([0, 4], dtype=torch.int32), X)
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, q, q)
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        ops.rbf_block(meta, meta)
    meta = torch.empty(1, 2, 8, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        ops.attention(meta, meta, meta)
