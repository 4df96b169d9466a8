"""The ``cuda_ipc`` transport on the CPU, where its slots are shared
memory (``core/dist.py``).

One spawn of 4 ranks started on ``cuda_ipc`` (a gloo group for control
messages) runs every case, each against the gloo transport in the same
ranks:

* ``ppermute`` on ring and RHD permutations, a lone pair (the other
  ranks get zeros) and RHD's pre-fold, bit-identical to
  gloo; ``all_gather`` likewise; on a 3-rank subgroup, the non-power-
  of-two RHD allreduce and the zero-fill;
* 50 back-to-back hops to one peer with mixed sizes, through both
  slots, and a coded payload whose scale rides in its slot;
* full ``GradientAggregator`` calls (rhd_rsa + int8 fused, ring_rsa +
  int8, ring_rsa, fused ps_gather, and error feedback), two steps each,
  bit-identical to gloo and to the uncached path (no plan cache, no
  executor), and within ``codec.tolerance`` of the exact mean
  (integer-valued inputs exactly), with the executors built once;
* refusals: a group across hosts, a mapping that fails on one rank, a
  payload larger than its slot, and a group with no channel, each
  raising on every rank;
* the control mailbox: a notify other than the one expected raises, a
  wait that outlasts the channel's timeout raises naming the peer, and
  channels open and close collectively (one name on every rank, every
  mapping dropped on close).
"""
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro_torch.core import AggregatorConfig, GradientAggregator, codec
from repro_torch.core import dist, plan_cache, reducers, schedule

P = 4
SLOT = 4096
N = 37
AGG_CASES = {
    "rhd_int8": dict(strategy="rhd_rsa", codec="int8"),
    "ring_int8": dict(strategy="ring_rsa", codec="int8"),
    "ring": dict(strategy="ring_rsa"),
    "ps_fused": dict(strategy="ps_gather", fused_hops=True),
    "rhd_int8_ef": dict(strategy="rhd_rsa", codec="int8",
                        error_feedback=True),
}
STEPS = 2


def _grads(rank, step, integer):
    """A tree that fuses into a multi-leaf bucket and a single-leaf one
    (threshold 1 KiB)."""
    rng = np.random.default_rng(1000 * step + rank)
    if integer:
        def draw(*s):
            return rng.integers(-50, 50, s).astype(np.float32)
    else:
        def draw(*s):
            return rng.standard_normal(s).astype(np.float32)
    big = draw(300, 3)
    big[0, 0] = 20.0
    return {"b": torch.from_numpy(draw(7)), "c": [torch.from_numpy(draw(5,
                                                                       3))],
            "w": torch.from_numpy(big)}


def _uncached(cfg, grads, groups, dp_size):
    """The aggregator's arithmetic without plan cache or executor: plan,
    flatten into fresh buffers, cast, run the stages, scale, cast back."""
    sched = schedule.plan(
        grads, axis_names=("data",), axis_sizes=(dp_size,),
        strategy=cfg.strategy, threshold_bytes=cfg.threshold_bytes,
        fuse=cfg.fuse, wire_dtype=cfg.wire_dtype or cfg.accum_dtype,
        codec=cfg.codec, fused_hops=cfg.fused_hops)
    accum = schedule.DTYPES[cfg.wire_dtype or cfg.accum_dtype]
    out = []
    for bucket, buf in zip(sched.buckets, sched.plan.flatten(grads)):
        red = reducers.execute_stages(buf.to(accum), bucket.stages, groups)
        out.append((red * (1.0 / dp_size)).to(buf.dtype))
    return sched.plan.unflatten(out)


def _perms():
    return {"ring": [(i, (i + 1) % P) for i in range(P)],
            "rhd1": [(i, i ^ 1) for i in range(P)],
            "rhd2": [(i, i ^ 2) for i in range(P)],
            "lone": [(0, 1)],
            "fold": [(3, 0)]}


def _expect_raise(fn):
    try:
        fn()
    except (RuntimeError, ValueError, TimeoutError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _refusals(rank, ipc, ch):
    out = {}
    real = dist.socket.gethostname
    if rank == 0:
        dist.socket.gethostname = lambda: "another-host"
    try:
        out["two_hosts"] = _expect_raise(
            lambda: dist.Group(transport="cuda_ipc"))
    finally:
        dist.socket.gethostname = real
    real_import = dist._import
    if rank == 1:
        def failing(handle):
            raise RuntimeError("mapping refused")
        dist._import = failing
    try:
        out["mapping"] = _expect_raise(
            lambda: dist.IpcChannel(ipc, SLOT, "cpu"))
    finally:
        dist._import = real_import
    out["too_big"] = _expect_raise(lambda: dist.ppermute(
        torch.zeros(SLOT // 4 + 1), ch.group, _perms()["ring"]))
    out["no_channel"] = _expect_raise(
        lambda: dist.ppermute(torch.zeros(3), ipc, _perms()["ring"]))
    return out


def _mailbox(rank, ipc):
    """Rank 0 publishes a wrong notify to rank 1; rank 2 waits for a
    notify that rank 3 never sends."""
    out = {}
    timeout, dist.MAILBOX_TIMEOUT_S = dist.MAILBOX_TIMEOUT_S, 1.0
    try:
        ch = dist.IpcChannel(ipc, SLOT, "cpu")
    finally:
        dist.MAILBOX_TIMEOUT_S = timeout
    with ch:
        like = [torch.zeros(3)]
        if rank == 0:
            ch._publish(1, dist._NOTIFY, (7, 1, 12))
        elif rank == 1:
            out["wrong"] = _expect_raise(
                lambda: ch.take(0, like, dist._clone_all))
        elif rank == 2:
            out["late"] = _expect_raise(
                lambda: ch.take(3, like, dist._clone_all))
        out["name"], out["open"] = ch.name, ch in dist._open_channels
    out["closed"] = [ch.closed, ch in dist._open_channels,
                     ch._peer_box is None, ch._box is None,
                     ch._send is None]
    return out


def _np(obj):
    """Tensors to numpy, through dicts, lists and tuples (a result
    holding torch tensors would be shared through file descriptors of a
    process that has exited)."""
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    if isinstance(obj, dict):
        return {k: _np(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_np(v) for v in obj)
    return obj


def _rank_cases(rank, world):
    torch.set_num_threads(1)
    ipc = dist.Group()
    gloo = dist.Group(transport="gloo")
    res = {"transport": ipc.transport}
    rng = np.random.default_rng(rank)
    x = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    with dist.IpcChannel(ipc, SLOT, "cpu") as ch:
        for name, perm in _perms().items():
            res[("ppermute", name)] = (dist.ppermute(x, ch.group, perm),
                                       dist.ppermute(x, gloo, perm))
        res["all_gather"] = (dist.all_gather(x, ch.group),
                             dist.all_gather(x, gloo))
        ring = _perms()["ring"]
        got = []
        for i in range(50):
            n = 1 + (97 * i) % (SLOT // 4)
            y = torch.full((n,), float(1000 * rank + i))
            got.append(dist.ppermute(y, ch.group, ring))
        res["back_to_back"] = got
        payload, scale = codec.encode("int8", x)
        res["coded"] = [codec._wire(payload, scale, g, ring,
                                    lambda r, s: codec.decode("int8", r, s))
                        for g in (ch.group, gloo)]
        res["mapped_bytes"] = dist.traffic["mapped_bytes"]
        res["refusals"] = _refusals(rank, ipc, ch)
    res["mailbox"] = _mailbox(rank, ipc)

    pg3 = tdist.new_group([0, 1, 2])
    if rank < 3:
        g3 = dist.Group(pg3)
        with dist.IpcChannel(g3, SLOT, "cpu") as ch3:
            gl3 = dist.Group(pg3, transport="gloo")
            res["p3_rhd"] = (reducers.rhd_rsa(x, ch3.group),
                             reducers.rhd_rsa(x, gl3))
            res["p3_fold"] = (dist.ppermute(x, ch3.group, [(2, 0)]),
                              dist.ppermute(x, gl3, [(2, 0)]))

    for name, cfg in AGG_CASES.items():
        integer = "codec" not in cfg
        config = AggregatorConfig(fusion_threshold_mb=1 / 1024, **cfg)
        if not config.error_feedback:
            res[("agg", name, "uncached")] = [
                _uncached(config, _grads(rank, step, integer),
                          {"data": gloo}, world) for step in range(STEPS)]
        for label, group in (("ipc", ipc), ("gloo", gloo)):
            agg = GradientAggregator(config, ("data",), {"data": group})
            steps, residuals = [], None
            for step in range(STEPS):
                grads = _grads(rank, step, integer)
                if cfg.get("error_feedback"):
                    if residuals is None:
                        residuals = agg.init_residuals(grads)
                    out, residuals = agg(grads, residuals=residuals)
                    steps.append((out, residuals))
                else:
                    steps.append(agg(grads))
            ex = plan_cache.GLOBAL_EXECUTOR_CACHE.executor_for(
                agg.last_schedule, agg.groups, "cpu")
            res[("agg", name, label)] = steps
            res[("exec", name, label)] = (
                ex.traces, ex.calls, len(ex.channels),
                [b is not None for b in ex.buffers])
    res["plan_cache"] = plan_cache.GLOBAL_PLAN_CACHE.stats()
    return _np(res)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rdv = tmp_path_factory.mktemp("rdv_ipc")
    return dist.run_ranks(_rank_cases, P, backend="cuda_ipc",
                          rendezvous_dir=str(rdv), threads=1,
                          timeout_s=240)


def _flat(obj):
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _flat(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _flat(o)]
    return [obj]


def _same_bits(a, b):
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(fa, fb))


def test_world_group_takes_the_launch_transport(ranks):
    assert all(r["transport"] == "cuda_ipc" for r in ranks)


@pytest.mark.parametrize("perm", list(_perms()))
def test_ppermute_bit_identical_to_gloo(ranks, perm):
    for rank, r in enumerate(ranks):
        got, want = r[("ppermute", perm)]
        assert np.array_equal(got, want), f"rank {rank}"
        targets = {d for _, d in _perms()[perm]}
        if rank not in targets:
            assert not got.any(), f"rank {rank} not zeroed"


def test_all_gather_bit_identical_to_gloo(ranks):
    xs = [np.random.default_rng(r).standard_normal(N).astype(np.float32)
          for r in range(P)]
    for r in ranks:
        got, want = r["all_gather"]
        assert np.array_equal(got, want)
        assert np.array_equal(got, np.stack(xs))


def test_back_to_back_hops_reuse_slots(ranks):
    for rank, r in enumerate(ranks):
        src = (rank - 1) % P
        for i, got in enumerate(r["back_to_back"]):
            n = 1 + (97 * i) % (SLOT // 4)
            assert got.shape == (n,)
            assert np.array_equal(got, np.full((n,), 1000.0 * src + i,
                                                 np.float32))
        assert r["mapped_bytes"] > 0


def test_coded_payload_and_scale_share_a_slot(ranks):
    for r in ranks:
        ipc, gloo = r["coded"]
        assert np.array_equal(ipc, gloo)


def test_three_rank_subgroup(ranks):
    for rank, r in enumerate(ranks[:3]):
        got, want = r["p3_rhd"]
        assert np.array_equal(got, want)
        got, want = r["p3_fold"]
        assert np.array_equal(got, want)
        if rank != 0:
            assert not got.any()
    assert np.array_equal(ranks[0]["p3_rhd"][0], ranks[2]["p3_rhd"][0])


@pytest.mark.parametrize("case", list(AGG_CASES))
def test_aggregator_bit_identical_to_gloo(ranks, case):
    for rank, r in enumerate(ranks):
        assert _same_bits(r[("agg", case, "ipc")], r[("agg", case, "gloo")]), \
            f"rank {rank}: {case} differs between transports"
    def reduced(r):           # residuals are each rank's own
        steps = r[("agg", case, "ipc")]
        return [s[0] for s in steps] if AGG_CASES[case].get(
            "error_feedback") else steps

    for r in ranks[1:]:
        assert _same_bits(reduced(r), reduced(ranks[0]))


@pytest.mark.parametrize("case", [c for c in AGG_CASES
                                  if not AGG_CASES[c].get("error_feedback")])
def test_aggregator_through_executor_matches_uncached_path(ranks, case):
    for r in ranks:
        assert _same_bits(r[("agg", case, "ipc")],
                          r[("agg", case, "uncached")])


@pytest.mark.parametrize("case", list(AGG_CASES))
def test_aggregator_within_codec_tolerance(ranks, case):
    cfg = AGG_CASES[case]
    name = cfg.get("codec", "none")
    from repro_torch import tree
    for step in range(STEPS):
        leaves = [tree.leaves(_grads(r, step, name == "none"))
                  for r in range(P)]
        got = ranks[0][("agg", case, "ipc")][step]
        if cfg.get("error_feedback"):
            if step:
                continue      # later steps carry the residual forward
            got = got[0]
        for i, out in enumerate(tree.leaves(got)):
            xs = np.stack([lv[i].numpy() for lv in leaves]).astype(np.float64)
            exact = xs.sum(axis=0)
            err = np.abs(out.astype(np.float64) * P - exact).max()
            bound = codec.tolerance(name, P) * np.abs(
                np.stack([np.concatenate([v.numpy().ravel() for v in lv])
                          for lv in leaves])).max()
            assert err <= bound, f"{case} step {step} leaf {i}"


@pytest.mark.parametrize("case", list(AGG_CASES))
def test_executors_built_once(ranks, case):
    for r in ranks:
        for label in ("ipc", "gloo"):
            traces, calls, n_channels, owned = r[("exec", case, label)]
            assert (traces, calls) == (1, STEPS)
            assert n_channels == (label == "ipc")
            assert any(owned)          # the multi-leaf bucket is owned


def test_plan_cache_hits_after_the_first_step(ranks):
    for r in ranks:
        snap = r["plan_cache"]
        # One build per configuration: the gloo aggregator of the same
        # configuration resolves the same request, a hit.
        assert snap["misses"] == len(AGG_CASES)
        assert set(snap["builds"].values()) == {1}
        assert snap["hits"] >= len(AGG_CASES) * (2 * STEPS - 1)


@pytest.mark.parametrize("what", ["two_hosts", "mapping", "too_big",
                                  "no_channel"])
def test_refusals_raise_on_every_rank(ranks, what):
    msgs = [r["refusals"][what] for r in ranks]
    assert all(m is not None for m in msgs), msgs
    if what == "two_hosts":
        assert all("spans hosts" in m for m in msgs)
    if what == "mapping":
        assert all("mapping the peers' receive slots failed" in m
                   for m in msgs)


def test_mailbox_wrong_message_raises(ranks):
    msg = ranks[1]["mailbox"]["wrong"]
    assert msg.startswith("RuntimeError") and "[7, 1, 12]" in msg, msg
    assert "expected (seq, slot, bytes) [0, 0, 12]" in msg, msg


def test_mailbox_wait_times_out_naming_the_peer(ranks):
    box = ranks[2]["mailbox"]
    assert box["late"].startswith("TimeoutError"), box
    assert "from rank 3" in box["late"] and box["name"] in box["late"]
    assert "expected seq 0" in box["late"]


def test_channels_open_and_close_collectively(ranks):
    assert len({r["mailbox"]["name"] for r in ranks}) == 1
    assert all(r["mailbox"]["open"] for r in ranks)
    assert all(r["mailbox"]["closed"] == [True, False, True, True, True]
               for r in ranks)


class _FakeAxis:
    """A rank of a group of ``size`` that only counts (no process group)."""

    def __init__(self, size, rank):
        self.size, self.rank = size, rank


@pytest.mark.parametrize("shape", [(37,), (5, 3), (1, 4, 2), (64,)])
@pytest.mark.parametrize("alg", ["ring_rsa", "rhd_rsa"])
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_hop_elements_is_the_largest_hop(p, alg, shape):
    """What the executor sizes its slots by: the largest payload any
    rank sends in one allreduce, counted by a permute that records."""
    sent = []

    def record(x, group, perm):
        sent.append(x.numel())
        return torch.zeros_like(x)

    for rank in range(p):
        getattr(reducers, alg)(torch.ones(shape), _FakeAxis(p, rank),
                               permute=record)
    assert reducers.hop_elements(alg, shape, p) == (max(sent), 0)
    assert reducers.hop_elements("ps_gather", shape, p) == (
        0, int(np.prod(shape)))
