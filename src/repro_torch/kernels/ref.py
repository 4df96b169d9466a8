"""Plain-torch oracles for the kernels (counterpart of ``repro/kernels/ref.py``).

The oracle of K5 is the plain version that lives beside its kernel in
``fused_adamw.py``; it is the same function, term for term, as the
reference's ``adamw_update_ref``.
"""
from __future__ import annotations

from .fused_adamw import adamw_update_plain as adamw_update_ref

__all__ = ["adamw_update_ref"]
