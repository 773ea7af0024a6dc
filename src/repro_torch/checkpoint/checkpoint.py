"""Checkpoint/restore with atomic step directories, the port of
``checkpoint/checkpoint.py``, in the reference's layout:

    <dir>/step_00000123/        — one directory per step
        manifest.json           — leaf paths, shapes, dtypes, metadata
        shard_<host>.npz        — this host's leaves (here one host)
    <dir>/step_00000123.tmp/    — staging; renamed atomically when complete

A crash mid-save never corrupts the latest checkpoint (the manifest is
written last, into the staging directory, which is renamed after it);
``latest_step`` sees complete checkpoints only; ``keep`` retains the
newest. Trees are anything ``torch.utils._pytree`` flattens (dicts, lists,
tuples, named tuples) with tensors at the leaves, which go to numpy
through ``.cpu()``. numpy has no bfloat16: a bf16 leaf is saved losslessly
as its 16-bit patterns (int16) and the manifest records "bfloat16", so
restoring gives back the same bits.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch
from torch.utils._pytree import (keystr, tree_flatten, tree_flatten_with_path,
                                 tree_unflatten)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array, dtype name) of one leaf; bf16 as its int16 bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy(), name
    a = np.asarray(leaf)
    return a, str(a.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    keep: int = 3, host_id: int = 0,
                    metadata: dict | None = None) -> str:
    """Atomically write ``tree`` for ``step``. Returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat, _ = tree_flatten_with_path(tree)
    paths = [keystr(path) for path, _ in flat]
    arrays = [_to_numpy(leaf) for _, leaf in flat]
    np.savez(os.path.join(tmp, f"shard_{host_id}.npz"),
             **{f"leaf_{i}": a for i, (a, _) in enumerate(arrays)})
    manifest = {
        "step": step,
        "n_leaves": len(arrays),
        "paths": paths,
        "shapes": [list(a.shape) for a, _ in arrays],
        "dtypes": [name for _, name in arrays],
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            path = os.path.join(ckpt_dir, name, "manifest.json")
            if os.path.exists(path):     # complete checkpoints only
                out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any, *,
                       host_id: int = 0) -> Any:
    """Restore into the structure of ``like``: each tensor leaf comes back
    on the device and in the dtype of ``like``'s leaf."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like, spec = tree_flatten(like)
    if len(flat_like) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, structure "
            f"expects {len(flat_like)}")
    with np.load(os.path.join(path, f"shard_{host_id}.npz")) as data:
        leaves = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    restored = []
    for a, name, ref in zip(leaves, manifest["dtypes"], flat_like):
        t = torch.from_numpy(a)
        if name == "bfloat16":
            t = t.view(torch.bfloat16)
        if isinstance(ref, torch.Tensor):
            t = t.to(device=ref.device, dtype=ref.dtype)
        restored.append(t)
    return tree_unflatten(restored, spec)
