"""The ``cuda_ipc`` transport on the card, against gloo in the same ranks.

Imports neither jax nor the reference, so it runs on a machine that has
only PyTorch for CUDA:

    PYTHONPATH=src python -m pytest -q tests/test_torch_transport_on_card.py

Without a card every test skips (decided in the ``cuda`` fixture, when a
test runs).  Two ranks spawned on one card run ``ppermute`` (ring, a
lone pair whose non-target gets zeros, 50 back-to-back hops of mixed
sizes through both slots), a coded hop through K2/K3 whose decode reads
the slot in place, ``all_gather`` and a full ``GradientAggregator``
(rhd_rsa + int8 fused) on ``cuda_ipc``, each bit-identical to the gloo
transport; ``torch.profiler`` over the cuda_ipc calls must show device
copies and no copy between the host and the card, and the transport's
own count of staged bytes must not move.
"""
import tempfile

import numpy as np
import pytest
import torch

P = 2
SLOT = 1 << 20
N = 100_003


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _copies(prof) -> dict:
    """Count of the profiled device copies by direction."""
    out = {"host<->device": 0, "device<->device": 0}
    for e in prof.events():
        if not e.name.startswith("Memcpy"):
            continue
        if "HtoD" in e.name or "DtoH" in e.name:
            out["host<->device"] += 1
        elif "DtoD" in e.name or "PtoP" in e.name:
            out["device<->device"] += 1
    return out


def _cases(group, rank):
    from repro_torch.core import AggregatorConfig, GradientAggregator, codec
    from repro_torch.core import dist
    from repro_torch.kernels import fused_hop
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(rank)
    x = torch.randn(N, generator=gen, device=dev)
    ring = [(i, (i + 1) % P) for i in range(P)]
    out = {"ring": dist.ppermute(x, group, ring),
           "lone": dist.ppermute(x, group, [(1, 0)]),
           "gather": dist.all_gather(x, group)}
    hops = []
    for i in range(50):
        n = 1 + (7919 * i) % (SLOT // 4)
        hops.append(dist.ppermute(x[:n] + i, group, ring))
    out["hops"] = hops
    payload, scale = fused_hop.hop_encode("int8", x)
    out["coded"] = codec._wire(
        payload, scale, group, ring,
        lambda r, s: fused_hop.hop_decode_add("int8", r, s, x))
    grads = {"a": torch.randn(3000, 7, generator=gen, device=dev),
             "b": torch.randn(11, generator=gen, device=dev)}
    agg = GradientAggregator(AggregatorConfig(codec="int8",
                                              fusion_threshold_mb=0.05),
                             ("data",), {"data": group})
    out["agg"] = [agg(grads), agg(grads)]
    torch.cuda.synchronize()
    return out


def _np(out):
    from repro_torch import tree
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
            else [t.cpu().numpy() for t in tree.leaves(v)]
            for k, v in out.items()}


def _rank(rank, world):
    from repro_torch.core import dist
    torch.cuda.set_device(0)
    ipc = dist.Group()
    gloo = dist.Group(transport="gloo")
    res = {"gloo": _np(_cases(gloo, rank))}
    with dist.IpcChannel(ipc, SLOT, "cuda") as ch:
        _cases(ch.group, rank)                 # warm-up: kernels, CUPTI
        staged = dist.traffic["staged_bytes"]
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            ipc_out = _cases(ch.group, rank)
        res["staged_bytes"] = dist.traffic["staged_bytes"] - staged
        res["copies"] = _copies(prof)
        res["ipc"] = _np(ipc_out)
    return res


@pytest.fixture(scope="module")
def ranks(cuda):
    from repro_torch.core import dist
    with tempfile.TemporaryDirectory() as rdv:
        return dist.run_ranks(_rank, P, backend="cuda_ipc",
                              rendezvous_dir=rdv, timeout_s=300)


def test_cuda_ipc_matches_gloo_on_card(ranks):
    for rank, r in enumerate(ranks):
        for key, want in r["gloo"].items():
            got = r["ipc"][key]
            if isinstance(want, list):
                assert len(got) == len(want)
                assert all(np.array_equal(a, b) for a, b in zip(got, want)), \
                    f"rank {rank}: {key}"
            else:
                assert np.array_equal(got, want), f"rank {rank}: {key}"
        if rank == 1:
            assert not r["ipc"]["lone"].any()


def test_cuda_ipc_payloads_never_touch_the_host(ranks):
    for r in ranks:
        # The aggregator's mean_scalar is not called here, and no psum
        # runs: every byte moved stays on the card.
        assert r["staged_bytes"] == 0
        assert r["copies"]["host<->device"] == 0, r["copies"]
        assert r["copies"]["device<->device"] > 0, r["copies"]
