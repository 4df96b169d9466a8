"""Parameters and tensors between numpy and the port.

``params_from_numpy`` takes the reference's parameter tree as numpy
arrays (nested dicts, the same names and shapes) and returns the port's
tensors; ``params_to_numpy`` goes back.  ``tensor_from_numpy`` and
``tensor_to_numpy`` also carry bfloat16 and float8_e4m3fn arrays (the
``ml_dtypes`` types numpy-side) through their raw bits.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tree as tree_mod

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
