"""The CUDA kernels against their plain torch versions, on the card.

Imports neither jax nor the reference, so it runs on a machine that has
only PyTorch for CUDA:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_on_card.py

Without a card every test skips (decided in the ``cuda`` fixture, when a
test runs).  K1/K2/K3 must be bit-exact; K5 within 1 ulp.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_adamw as fa
from repro_torch.kernels import fused_hop as fh


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _normal(n, seed, outlier=False):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if outlier:
        x[n // 3] = 1e4
    return torch.from_numpy(x)


def _ulp_distance(a, b) -> int:
    def ordered(t):
        i = t.detach().cpu().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("name", ["bf16", "int8", "fp8_e4m3"])
def test_hop_kernels_match_plain_on_card(cuda, name):
    x = _normal(1 << 16, 1, outlier=True).to(cuda)
    add = _normal(1 << 16, 2).to(cuda)
    p, s = fh.hop_encode(name, x)
    pp, sp = fh.encode_plain(name, x)
    assert torch.equal(p.view(torch.uint8), pp.view(torch.uint8))
    assert (s is None and sp is None) or torch.equal(s, sp)
    for a in (add, None):
        assert torch.equal(fh.hop_decode_add(name, p, s, a),
                           fh.decode_add_plain(name, p, s, a))
    assert torch.equal(fh.hop_absmax(x), fh.absmax_plain(x))


def test_adamw_kernel_matches_plain_on_card(cuda):
    p = (_normal(1 << 16, 3) * 0.05).to(cuda)
    g = (_normal(1 << 16, 4) * 1e-3).to(cuda)
    m = (_normal(1 << 16, 5) * 1e-4).to(cuda)
    v = (_normal(1 << 16, 6) ** 2 * 1e-6).to(cuda)
    kw = dict(lr=1e-3, count=2)
    for a, b in zip(fa.adamw_update(p, g, m, v, **kw),
                    fa.adamw_update_plain(p, g, m, v, **kw)):
        assert _ulp_distance(a, b) <= 1


def test_wrappers_count_only_kernel_launches(cuda):
    x = _normal(4096, 7).to(cuda)
    before = (fh.hop_absmax.launches, fh.hop_encode.launches,
              fh.hop_decode_add.launches)
    fh.encode_plain("int8", x)                  # plain: no launch
    p, s = fh.hop_encode("int8", x)             # K1 + K2
    fh.hop_decode_add("int8", p, s)             # K3
    after = (fh.hop_absmax.launches, fh.hop_encode.launches,
             fh.hop_decode_add.launches)
    assert tuple(b - a for a, b in zip(before, after)) == (1, 1, 1)
