"""Parameters and tensors between numpy and the port.

``params_from_numpy`` takes the reference's parameter tree as numpy
arrays (nested dicts, the same names and shapes) and returns the port's
tensors; ``params_to_numpy`` goes back.  ``tensor_from_numpy`` and
``tensor_to_numpy`` also carry bfloat16 and float8_e4m3fn arrays (the
``ml_dtypes`` types numpy-side) through their raw bits.

On a model axis (``core/manual.py``) ``shard_from_numpy`` takes the
reference's full tree to one model rank's shards, and ``join_shards``
takes every model rank's shards (as numpy) back to the full tree.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tree as tree_mod
from .core.manual import sharded_dim

# numpy dtype name -> (same-width integer view on both sides, torch dtype)
_BITS = {"bfloat16": (np.int16, torch.int16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.uint8, torch.float8_e4m3fn)}


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    a = np.asarray(a)
    bits = _BITS.get(a.dtype.name)
    if bits is not None:
        raw = np.array(a, copy=True).view(bits[0])
        t = torch.from_numpy(raw).view(bits[2])
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device) if device is not None else t


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    for name, (_, t_bits, t_dtype) in _BITS.items():
        if t.dtype == t_dtype:
            import ml_dtypes   # numpy-side dtypes only; no jax
            return t.view(t_bits).numpy().copy().view(
                getattr(ml_dtypes, name))
    return t.numpy().copy()


def params_from_numpy(tree, device=None) -> dict:
    return tree_mod.tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(params) -> dict:
    return tree_mod.tree_map(tensor_to_numpy, params)


def shard_from_numpy(tree, mspecs, index: int, m: int, device=None) -> dict:
    """Model rank ``index``'s shards (of ``m``) of the full numpy tree:
    block ``index`` along each sharded dim, replicated leaves whole."""

    def leaf(a, spec):
        a = np.asarray(a)
        dim = sharded_dim(spec)
        if dim is not None and m > 1:
            n = a.shape[dim] // m
            a = np.take(a, range(index * n, (index + 1) * n), axis=dim)
        return tensor_from_numpy(a, device)

    return tree_mod.tree_map(leaf, tree, mspecs)


def join_shards(shards, mspecs) -> dict:
    """The full numpy tree from every model rank's shards (numpy trees,
    in model-rank order): the blocks of each sharded leaf concatenated
    along its sharded dim; a replicated leaf is model rank 0's."""

    def leaf(spec, *blocks):
        dim = sharded_dim(spec)
        return np.asarray(blocks[0]) if dim is None \
            else np.concatenate([np.asarray(b) for b in blocks], axis=dim)

    return tree_mod.tree_map(leaf, mspecs, *shards)
