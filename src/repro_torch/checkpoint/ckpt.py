"""Checkpointing: path-keyed npz snapshots of nested trees (counterpart
of ``repro/checkpoint/ckpt.py``, in its file format).

A leaf's key is its path joined by ``/`` (dict keys, list indices), as
the reference writes ``jax.tree_util``'s paths, so a checkpoint written
by either package restores in the other.  bfloat16 (and float8) leaves
are widened to float32 in the npz and restored to the template's dtype;
a Python ``int`` leaf (the optimizers' ``count``) is saved as a 0-d
int32 array, the reference's form, and restored as an ``int`` where the
template has one.  Files are ``ckpt_{step:08d}.npz``, written through a
temporary file and renamed.  Tensors are copied to the host; on a model
axis the caller saves the gathered tree (``Trainer`` does).
"""
from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch

from .. import tree as tree_mod


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.is_floating_point() and t.dtype not in (
                torch.float16, torch.float32, torch.float64):
            t = t.to(torch.float32)
        return t.numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    arr = np.asarray(leaf)
    # npz has no native bf16 (its kind is "V"): widen losslessly to f32
    return arr.astype(np.float32) if arr.dtype.kind not in "iufb" else arr


def save(directory: str, step: int, tree) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays = {_key(path): _to_numpy(leaf)
              for path, leaf in tree_mod.leaves_with_path(tree)}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def _restore_leaf(key: str, arr: np.ndarray, like):
    is_int = isinstance(like, int) and not isinstance(like, bool)
    shape = () if is_int else tuple(like.shape)
    if tuple(arr.shape) != shape:
        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {shape}")
    if is_int:
        return int(arr)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(dtype=like.dtype,
                                                  device=like.device)
    return np.asarray(arr).astype(like.dtype)


def restore(directory: str, step: int, like):
    """Restore into the structure of ``like`` (a template tree): each
    leaf takes the template leaf's dtype and device."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        flat = tree_mod.leaves_with_path(like)
        return tree_mod.unflatten(like, [
            _restore_leaf(_key(p), data[_key(p)], leaf) for p, leaf in flat])


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None
