"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for Hopper only (``sm_90a``) into
``build/repro_torch_kernels/`` at the root of the checkout. The library's
file name carries a hash of its source, the shared headers and the flags,
so an edited source is rebuilt and an unchanged one is reused. Every
missing library is compiled at once, one ``nvcc`` process per source, and
``ptxas -v`` (registers, shared memory, spills) is kept in a ``.log`` beside
each library.

Nothing here runs at import: the kernel wrappers import this module inside
the function that launches, so the CPU-only tests never need ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc was not found: the CUDA kernels are compiled at first use and "
        "need the CUDA toolkit (nvcc on PATH or /usr/local/cuda/bin)")


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes started together; returns each name's library path. Waits
    for every process it starts before raising on a failed one."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: library_path(name) for name in names}
    running = []
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        log = open(target.with_suffix(".log"), "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        running.append((name, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT), log, tmp, target))
    failed = []
    for name, proc, log, tmp, target in running:
        proc.wait()
        log.close()
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            f"nvcc failed for {', '.join(failed)}; see "
            + ", ".join(str(targets[n].with_suffix('.log')) for n in failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib
