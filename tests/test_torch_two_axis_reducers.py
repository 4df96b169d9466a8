"""Two dp axes (pod × data) on gloo ranks against the reference.

One spawn of 6 gloo ranks (file rendezvous) lays two meshes out: 3 pods
× 2 (all six, through ``launch.mesh.make_groups``; a non-pow2 pod count,
so RHD across pods takes its fold) and 2 pods × 2 (ranks 0-3, in the same
pod-major layout).  One
JAX subprocess with 6 host devices runs the reference's
``execute_stages`` on ``Mesh((pods, d), ("pod", "data"))`` from the same
numpy inputs.  The checks follow the reference's
``multidev_hierarchical_overlap_checks``:

* uncoded composed (``ring_rsa×{rhd_rsa,ring_rsa,psum}``,
  ``hierarchical``) and flat-fold buckets on integer-valued float32 are
  bit-exact with the exact sum and with the reference, through
  ``execute_stages`` and ``reducers.allreduce``;
* coded ones (``int8``, ``bf16×int8``; fused and plain hops) stay within
  the bound derived from ``codec.tolerance`` per stage, as the
  reference's are; fused equals unfused, and every rank holds the same
  bits;
* the aggregator's composed schedule, post-backward and overlapped, on
  gloo and on ``cuda_ipc`` (shared memory on the CPU; one channel per
  axis, each sized to its own axis's largest hop), and ``auto`` under an
  ``axes`` tuning table that mixes a flat fold and the composed schedule
  per bucket, are bit-exact with a ``psum`` aggregator; the coded
  composed schedule is bit-identical across transports and placements;
* the coded composed aggregator on gradients alike on every rank (the
  reference check's integer loss) and its error feedback over two steps
  are held to the reference's aggregator on the same inputs: residuals
  bit-exact, reduced gradients within the growth-aware bound of each
  bucket's own input absmax.  On those inputs the reference, too, ends
  outside its per-schedule bound (``_bound``), which is why the
  aggregator cases are held to ``_grown_bound``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.core import (AggregatorConfig, GradientAggregator, codec,
                              dist, plan_cache, reducers, schedule)
from repro_torch.launch.mesh import make_groups

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((2, 2), (3, 2))                # (pods, d)
WORLD = 6
AXES = ("pod", "data")
UNCODED = ("ring_rsa×rhd_rsa", "ring_rsa×ring_rsa", "ring_rsa×psum",
           "hierarchical", "rhd_rsa", "ring_rsa", "psum", "ps_gather")
FLAT = ("hierarchical", "rhd_rsa", "ring_rsa", "psum", "ps_gather")
SHAPES = ((37,), (5, 3))
CODED = ("ring_rsa×rhd_rsa", "ring_rsa×ring_rsa", "rhd_rsa", "ring_rsa")
SPECS = ("int8", "bf16×int8")
CODED_N = 257
INT_MB = 0.02
SWITCH = 32 * 1024


def _inputs(pods, d):
    p = pods * d
    rng = np.random.default_rng(10 * pods + d)
    out = {}
    for shape in SHAPES:
        out[f"int{shape}"] = rng.integers(-1000, 1000, (p,) + shape) \
            .astype(np.float32)
    x = rng.standard_normal((p, CODED_N)).astype(np.float32)
    x[0, 7] = 40.0
    out["coded"] = x
    return out


def _stages(strategy, pods, d, spec="none", fused=False):
    return schedule.decompose(strategy, 4 * CODED_N, AXES, (pods, d),
                              codec=spec, fused=fused)


def _bound(stages):
    """The reference's per-schedule codec bound (its verifier's
    ``codec_tolerance``): per coded stage ``codec.tolerance`` with the
    stage's hops, summed — ``allreduce_steps`` for an allreduce, size-1
    for a reduce-scatter or all-gather."""
    total = 0.0
    for st in stages:
        if st.codec == "none":
            continue
        hops = reducers.allreduce_steps(st.algorithm, st.axis_size) \
            if st.op == "allreduce" else st.axis_size - 1
        total += codec.tolerance(st.codec, st.axis_size, hops=hops)
    return total


def _grown_bound(stages):
    """The same per-stage tolerances, each scaled by the magnitude its
    hops carry when every rank's input is alike (correlated gradients):
    a stage enters with the input absmax times the sizes of the axes
    reduced before it, and a reduce-scatter or allreduce grows it by its
    own size on the way (``int8``'s tolerance already holds that
    growth).  ``_bound`` assumes the input absmax throughout, which
    correlated inputs exceed."""
    total, grown = 0.0, 1
    for st in stages:
        grows = st.op in ("reduce_scatter", "allreduce")
        if st.codec != "none":
            hops = reducers.allreduce_steps(st.algorithm, st.axis_size) \
                if st.op == "allreduce" else st.axis_size - 1
            within = st.axis_size if grows and st.codec != "int8" else 1
            total += codec.tolerance(st.codec, st.axis_size, hops=hops) \
                * grown * within
        if grows:
            grown *= st.axis_size
    return total


def _int_params(p):
    """Small fused leaves and one large bucket (the reference check's
    leaves): no level pads anything on these meshes."""
    return {"a": torch.ones((p * 32, 3)), "b": torch.ones((p * 32,)),
            "w": torch.ones((p * 12288,))}


def _int_loss(params, x):
    s = x.sum()
    total = torch.zeros(())
    for k in sorted(params):
        v = params[k]
        coeff = s + torch.arange(v.numel(), dtype=torch.float32) \
            .reshape(v.shape)
        total = total + (v * coeff).sum()
    return total


def _bucket_keys(sched):
    """Each bucket's leaf names (the tree's leaves are in key order)."""
    keys = sorted(_int_params(1))
    return [[keys[i] for i in b.leaf_indices] for b in sched.buckets]


def _agg_run(cfg, groups, p, x):
    params = {k: v.requires_grad_() for k, v in _int_params(p).items()}
    agg = GradientAggregator(cfg, AXES, groups,
                             cache=plan_cache.PlanCache())
    if cfg.overlap:
        grads = agg.overlap_params(params).backward(_int_loss(params, x))
    else:
        _int_loss(params, x).backward()
        grads = agg(tree.tree_map(lambda q: q.grad, params))
    sched = agg.last_schedule
    ex = plan_cache.GLOBAL_EXECUTOR_CACHE.executor_for(sched, agg.groups,
                                                       "cpu")
    return {"grads": {k: g.detach().numpy().copy()
                      for k, g in grads.items()},
            "strategies": sched.strategies(),
            "render": [b.render() for b in sched.buckets],
            "slots": {ch.group.name: ch.slot_bytes for ch in ex.channels},
            "overlap": agg.last_overlap is not None,
            "buckets": _bucket_keys(sched)}


def _ef_run(cfg, groups, p, x):
    """Two post-backward steps with error feedback, the residuals
    threaded from the first into the second."""
    params = {k: v.requires_grad_() for k, v in _int_params(p).items()}
    _int_loss(params, x).backward()
    grads = tree.tree_map(lambda q: q.grad, params)
    agg = GradientAggregator(cfg, AXES, groups,
                             cache=plan_cache.PlanCache())
    res = agg.init_residuals(grads)
    out = {"buckets": None}
    for step in (1, 2):
        reduced, res = agg(grads, residuals=res)
        out[step] = {"grads": {k: g.detach().numpy().copy()
                               for k, g in reduced.items()},
                     "residuals": [r.numpy().copy() for r in res]}
    out["buckets"] = _bucket_keys(agg.last_schedule)
    return out


def _table(pods, d):
    """Below ``SWITCH`` bytes the flat RHD fold wins, above it the
    composed schedule (the reference check's ``forced_axes_table``)."""
    return {"schema": "repro/allreduce-tuning/v1", "entries": [
        {"p": pods * d, "axes": [pods, d], "bytes": 0,
         "latency_us": {"rhd_rsa": 1.0, "ring_rsa×rhd_rsa": 5.0,
                        "psum": 9.0}},
        {"p": pods * d, "axes": [pods, d], "bytes": SWITCH,
         "latency_us": {"ring_rsa×rhd_rsa": 1.0, "rhd_rsa": 5.0,
                        "psum": 9.0}}]}


def _mesh_cases(rank, pods, d, groups, ipc, table):
    p = pods * d
    ins = _inputs(pods, d)
    res = {}
    for shape in SHAPES:
        x = torch.from_numpy(ins[f"int{shape}"][rank].copy())
        for strat in UNCODED:
            res[("stages", strat, shape)] = reducers.execute_stages(
                x, _stages(strat, pods, d), groups).numpy()
        for strat in FLAT:
            res[("allreduce", strat, shape)] = reducers.allreduce(
                x, (groups["pod"], groups["data"]), strat).numpy()
    x = torch.from_numpy(ins["coded"][rank].copy())
    for strat in CODED:
        for spec in SPECS:
            for fused in (False, True):
                res[("coded", strat, spec, fused)] = reducers.execute_stages(
                    x, _stages(strat, pods, d, spec, fused), groups).numpy()
    xs = torch.arange(p * 4, dtype=torch.float32)[rank * 4:(rank + 1) * 4]
    comp = dict(strategy="ring_rsa×rhd_rsa", fusion_threshold_mb=INT_MB)
    auto = dict(strategy="auto", selector_mode="empirical",
                selector_table=table, fusion_threshold_mb=INT_MB)
    coded = dict(comp, codec="bf16×int8")
    runs = {"post": (comp, groups), "overlap": (dict(comp, overlap=True),
                                                groups),
            "psum": (dict(strategy="psum", fusion_threshold_mb=INT_MB),
                     groups),
            "flat_overlap": (dict(strategy="rhd_rsa",
                                  fusion_threshold_mb=INT_MB, overlap=True),
                             groups),
            "ipc_post": (comp, ipc),
            "ipc_overlap": (dict(comp, overlap=True), ipc),
            "auto_overlap": (dict(auto, overlap=True), groups),
            "auto_post": (auto, groups),
            "ipc_auto_overlap": (dict(auto, overlap=True), ipc),
            "coded_post": (coded, groups),
            "coded_ipc_post": (coded, ipc),
            "coded_ipc_overlap": (dict(coded, overlap=True), ipc)}
    for label, (cfg, g) in runs.items():
        res[("agg", label)] = _agg_run(AggregatorConfig(**cfg), g, p, xs)
    res[("ef",)] = _ef_run(AggregatorConfig(**coded, error_feedback=True),
                           groups, p, xs)
    plan_cache.GLOBAL_EXECUTOR_CACHE.clear()     # closes the channels
    return res


def _mesh_groups(pods, d, transport=None):
    """The dp groups of a ``pods × d`` mesh.  A mesh of the whole world
    comes from ``make_groups``; a smaller one takes the world's first
    ``pods · d`` ranks in ``make_groups``'s pod-major layout (every rank
    creates every subgroup, in one order), and a rank outside it gets
    ``{}``."""
    world = torch.distributed.get_world_size()
    if pods * d == world:
        return make_groups(pods, d, transport=transport)
    rank = torch.distributed.get_rank()
    mine = {}
    for ax, lists in (("data", [range(k * d, (k + 1) * d)
                                for k in range(pods)]),
                      ("pod", [range(j, pods * d, d) for j in range(d)])):
        for members in lists:
            pg = torch.distributed.new_group(list(members))
            if rank in members:
                mine[ax] = pg
    if rank >= pods * d:
        return {}
    out = {ax: dist.Group(mine[ax], name=ax, transport=transport)
           for ax in ("data", "pod")}
    return {ax: out[ax] for ax in AXES}


def _rank_cases(rank, world, table_dir):
    torch.set_num_threads(1)
    out = {}
    for pods, d in MESHES:
        groups = _mesh_groups(pods, d)
        ipc = _mesh_groups(pods, d, transport="cuda_ipc")
        if not groups:
            continue
        assert (groups["pod"].rank, groups["data"].rank) == \
            (rank // d, rank % d)
        table = os.path.join(table_dir, f"table{pods}x{d}.json")
        out[(pods, d)] = _mesh_cases(rank, pods, d, groups, ipc, table)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("two_axis_tables")
    for pods, dd in MESHES:
        with open(d / f"table{pods}x{dd}.json", "w") as f:
            json.dump(_table(pods, dd), f)
    return dist.run_ranks(_rank_cases, WORLD, (str(d),),
                          rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
                          threads=1, timeout_s=300)


_JAX_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
from devflags import force_host_devices
force_host_devices(6)
import jax, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import AggregatorConfig, GradientAggregator, PlanCache
from repro.core import reducers, schedule
from repro.core.compat import shard_map

out_dir = sys.argv[2]
uncoded, coded, specs = (a.split(",") for a in sys.argv[3:6])
n, int_mb = int(sys.argv[6]), float(sys.argv[7])
out = {}


def int_loss(params, x):
    s = jax.numpy.sum(x)
    total = 0.0
    for k in sorted(params):
        v = params[k]
        coeff = s + jax.numpy.arange(v.size, dtype=np.float32).reshape(v.shape)
        total = total + jax.numpy.sum(v * coeff)
    return total


def stacked(tree):
    return jax.tree_util.tree_map(lambda a: a[None], tree)

for pods, d in ((2, 2), (3, 2)):
    p = pods * d
    mesh = Mesh(np.array(jax.devices()[:p]).reshape(pods, d), ("pod", "data"))
    inputs = dict(np.load(f"{out_dir}/in{pods}x{d}.npz"))
    cases = {}
    for key in inputs:
        if key.startswith("int"):
            for s in uncoded:
                cases[f"{s}|{key}"] = (key, schedule.decompose(
                    s, 4 * n, ("pod", "data"), (pods, d)))
    for s in coded:
        for c in specs:
            cases[f"{s}|{c}"] = ("coded", schedule.decompose(
                s, 4 * n, ("pod", "data"), (pods, d), codec=c, fused=True))

    def local(xs):
        return {k: reducers.execute_stages(xs[src], st)
                for k, (src, st) in cases.items()}

    spec = P(("pod", "data"))
    fn = jax.jit(shard_map(local, mesh, in_specs=({k: spec for k in inputs},),
                           out_specs={k: spec for k in cases},
                           check_vma=False))
    glob = {k: v.reshape((p * v.shape[1],) + v.shape[2:])
            for k, v in inputs.items()}
    res = fn(glob)
    for k, (src, _) in cases.items():
        out[f"{pods}x{d}|{k}"] = np.asarray(res[k]).reshape(inputs[src].shape)

    # The aggregator on gradients alike on every rank (the reference
    # check's integer loss), coded, and with error feedback for two steps.
    cfg = dict(strategy="ring_rsa×rhd_rsa", codec="bf16×int8",
               fusion_threshold_mb=int_mb)
    agg = GradientAggregator(AggregatorConfig(**cfg), ("pod", "data"),
                             cache=PlanCache())
    ef = GradientAggregator(AggregatorConfig(**cfg, error_feedback=True),
                            ("pod", "data"), cache=PlanCache())

    def agg_local(params, x):
        g = jax.grad(int_loss)(params, x)
        r0 = ef.init_residuals(g)
        g1, r1 = ef(g, residuals=r0)
        g2, r2 = ef(g, residuals=r1)
        return stacked({"coded": agg(g), "ef1": g1, "ef2": g2,
                        "res1": list(r1), "res2": list(r2)})

    params = {"a": np.ones((p * 32, 3), np.float32),
              "b": np.ones((p * 32,), np.float32),
              "w": np.ones((p * 12288,), np.float32)}
    fn = jax.jit(shard_map(agg_local, mesh, in_specs=(P(), spec),
                           out_specs=spec, check_vma=False))
    got = fn(params, np.arange(p * 4, dtype=np.float32))
    for run in ("coded", "ef1", "ef2"):
        for k, v in got[run].items():
            out[f"{pods}x{d}|agg|{run}|{k}"] = np.asarray(v)
    for run in ("res1", "res2"):
        for i, v in enumerate(got[run]):
            out[f"{pods}x{d}|agg|{run}|{i}"] = np.asarray(v)
np.savez(f"{out_dir}/out.npz", **out)
print("JAX TWO-AXIS DONE")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_two_axis")
    for pods, dd in MESHES:
        np.savez(d / f"in{pods}x{dd}.npz", **_inputs(pods, dd))
    script = d / "ref.py"
    script.write_text(_JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["REPRO_TEST_DEVICES"] = str(WORLD)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(script), os.path.join(ROOT, "tests"), str(d),
         ",".join(UNCODED), ",".join(CODED), ",".join(SPECS),
         str(CODED_N), str(INT_MB)], capture_output=True, text=True,
        timeout=300,
        env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "JAX TWO-AXIS DONE" in proc.stdout
    return dict(np.load(d / "out.npz"))


def _mesh(ranks, pods, d):
    return [r[(pods, d)] for r in ranks[:pods * d]]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("strategy", UNCODED)
@pytest.mark.parametrize("mesh", MESHES)
def test_uncoded_two_axis_bit_exact(ranks, reference, mesh, strategy, shape):
    pods, d = mesh
    x = _inputs(pods, d)[f"int{shape}"]
    exact = x.sum(axis=0)
    want = reference[f"{pods}x{d}|{strategy}|int{shape}"]
    for rank, res in enumerate(_mesh(ranks, pods, d)):
        got = res[("stages", strategy, shape)]
        assert np.array_equal(got, exact), f"rank {rank}: != exact sum"
        assert np.array_equal(got.view(np.uint32), want[rank].view(np.uint32))
        if strategy in FLAT:
            assert np.array_equal(res[("allreduce", strategy, shape)],
                                  exact)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("strategy", CODED)
@pytest.mark.parametrize("mesh", MESHES)
def test_coded_two_axis_within_derived_tolerance(ranks, reference, mesh,
                                                 strategy, spec, fused):
    pods, d = mesh
    x = _inputs(pods, d)["coded"]
    exact = x.astype(np.float64).sum(axis=0)
    stages = _stages(strategy, pods, d, spec, fused)
    assert any(st.codec != "none" for st in stages)
    bound = _bound(stages) * float(np.max(np.abs(x)))
    ref = reference[f"{pods}x{d}|{strategy}|{spec}"]
    results = _mesh(ranks, pods, d)
    for rank, res in enumerate(results):
        got = res[("coded", strategy, spec, fused)]
        assert float(np.max(np.abs(got - exact))) <= bound, \
            f"rank {rank}: {strategy}/{spec} outside the derived bound"
        assert float(np.max(np.abs(ref[rank] - exact))) <= bound
        assert np.array_equal(got, res[("coded", strategy, spec, not fused)])
    first = results[0][("coded", strategy, spec, fused)]
    for res in results[1:]:
        assert np.array_equal(res[("coded", strategy, spec, fused)], first)


def _expected_mean(p):
    s_total = float(sum(np.arange(p * 4, dtype=np.float64)))
    out = {}
    for k, v in _int_params(p).items():
        total = (s_total + p * np.arange(v.numel(), dtype=np.float64)) \
            .astype(np.float32)
        out[k] = (total * np.float32(1.0 / p)).reshape(tuple(v.shape))
    return out


@pytest.mark.parametrize("label", ["post", "overlap", "flat_overlap",
                                   "ipc_post", "ipc_overlap", "auto_overlap",
                                   "auto_post", "ipc_auto_overlap"])
@pytest.mark.parametrize("mesh", MESHES)
def test_aggregator_two_axis_bit_exact_with_psum(ranks, mesh, label):
    pods, d = mesh
    want = _expected_mean(pods * d)
    for rank, res in enumerate(_mesh(ranks, pods, d)):
        run, psum = res[("agg", label)], res[("agg", "psum")]
        assert run["overlap"] == label.endswith("overlap")
        for k in want:
            assert np.array_equal(run["grads"][k], psum["grads"][k]), \
                f"rank {rank} {label}: {k} != psum"
            assert np.array_equal(run["grads"][k], want[k])


@pytest.mark.parametrize("mesh", MESHES)
def test_composed_and_mixed_auto_schedules(ranks, mesh):
    pods, d = mesh
    res = _mesh(ranks, pods, d)[0]
    assert res[("agg", "post")]["strategies"] == ("ring_rsa×rhd_rsa",)
    assert set(res[("agg", "post")]["render"]) == {"ring@data×rhd@pod"}
    assert res[("agg", "flat_overlap")]["render"] == \
        ["rhd@data×rhd@pod"] * len(res[("agg", "flat_overlap")]["render"])
    for label in ("auto_overlap", "auto_post", "ipc_auto_overlap"):
        assert set(res[("agg", label)]["strategies"]) == \
            {"rhd_rsa", "ring_rsa×rhd_rsa"}, label
    assert set(res[("agg", "coded_post")]["render"]) == \
        {"ring@data:bf16×rhd@pod:int8"}


def test_each_axis_channel_sized_to_its_own_hops(ranks):
    """2 × 2, uncoded: the largest bucket is ``w`` (49,152 f32 rows): its
    data hop carries half the rows, its pod hop half the chunk.  bf16 ×
    int8: the data hop in bf16, the pod hop in int8 plus its scale."""
    for res in _mesh(ranks, 2, 2):
        assert res[("agg", "ipc_post")]["slots"] == \
            {"pod": 12288 * 4, "data": 24576 * 4}
        assert res[("agg", "coded_ipc_post")]["slots"] == \
            {"pod": 12288 + 16, "data": 24576 * 2}
        assert res[("agg", "post")]["slots"] == {}


def _int_grads(p):
    """Every rank's gradient of ``_int_loss`` (``s_r + arange``) as
    float64, rank first."""
    out = {}
    for k, v in _int_params(p).items():
        s = np.array([np.arange(r * 4, (r + 1) * 4).sum() for r in range(p)],
                     np.float64)
        out[k] = (s[:, None] + np.arange(v.numel())).reshape(
            (p,) + tuple(v.shape))
    return out


def _flat(arrays, keys):
    """A bucket's fused buffer, rank first: its leaves flattened and
    concatenated in the bucket's order."""
    return np.concatenate([arrays[k].reshape(arrays[k].shape[0], -1)
                           for k in keys], axis=1)


def _bucket_bound(p, pods, d, keys, inputs=None):
    """The growth-aware bound on the mean of one bucket of the coded
    composed schedule: ``_grown_bound`` times that bucket's own largest
    input absmax over all ranks, over p."""
    inputs = _int_grads(p) if inputs is None else inputs
    absmax = float(np.max(np.abs(_flat(inputs, keys))))
    stages = _stages("ring_rsa×rhd_rsa", pods, d, "bf16×int8", True)
    return _grown_bound(stages) * absmax / p, _bound(stages) * absmax / p


@pytest.mark.parametrize("mesh", MESHES)
def test_coded_composed_identical_across_transports_and_ranks(ranks, mesh):
    pods, d = mesh
    p = pods * d
    results = _mesh(ranks, pods, d)
    exact = _expected_mean(p)
    buckets = results[0][("agg", "coded_post")]["buckets"]
    assert sorted(k for ks in buckets for k in ks) == sorted(exact)
    for rank, res in enumerate(results):
        base = res[("agg", "coded_post")]["grads"]
        for label in ("coded_ipc_post", "coded_ipc_overlap"):
            for k, v in res[("agg", label)]["grads"].items():
                assert np.array_equal(v, base[k]), f"rank {rank} {label} {k}"
        for k, v in base.items():
            assert np.array_equal(v, results[0][("agg", "coded_post")]
                                  ["grads"][k]), f"rank {rank} {k}"
        for keys in buckets:
            bound, _ = _bucket_bound(p, pods, d, keys)
            for k in keys:
                assert float(np.max(np.abs(base[k] - exact[k]))) <= bound, \
                    f"rank {rank} {k}: outside its bucket's bound"


def alike_against_reference(results, reference, pods, d):
    """Per bucket of the coded composed aggregator on alike inputs: the
    port's error from the exact mean (worst rank) beside the
    reference's, both within the growth-aware bound, the port's no
    larger.  ``results``: each rank's ``_agg_run`` result, rank order;
    ``reference``: the JAX subprocess's ``{pods}x{d}|agg|coded|<leaf>``
    arrays.  Returns whether each bucket's reference error is over the
    per-schedule bound."""
    p = pods * d
    exact = _expected_mean(p)
    over = []
    for keys in results[0]["buckets"]:
        bound, flat_bound = _bucket_bound(p, pods, d, keys)
        ref_err = max(float(np.max(np.abs(
            reference[f"{pods}x{d}|agg|coded|{k}"] - exact[k][None])))
            for k in keys)
        port_err = max(float(np.max(np.abs(res["grads"][k] - exact[k])))
                       for res in results for k in keys)
        print(f"{pods} x {d} {keys}: reference {ref_err}, port {port_err}, "
              f"per-schedule bound {flat_bound}, grown bound {bound}")
        assert ref_err <= bound and port_err <= bound, (keys, ref_err,
                                                        port_err, bound)
        assert port_err <= ref_err, (keys, port_err, ref_err)
        over.append(ref_err > flat_bound)
    return over


@pytest.mark.parametrize("mesh", MESHES)
def test_coded_composed_alike_inputs_against_reference(ranks, reference,
                                                       mesh):
    """The reference's aggregator on the same alike inputs: per bucket,
    both errors from the exact mean within the growth-aware bound, and
    the port's no larger than the reference's, with the RHD fold (3
    pods) as without it.  The port's forwarding hops keep what they sent
    (replicas identical) and ship each chunk they join at the scale it
    was decoded at, so a chunk is rounded once; the reference's sender
    keeps its unquantized copy and re-encodes joined chunks at one
    scale.  On 2 × 2 the large bucket's reference error (385) is over
    the per-schedule bound (~290): the witness that ``_grown_bound``,
    not ``_bound``, holds on such inputs."""
    pods, d = mesh
    results = [res[("agg", "coded_post")]
               for res in _mesh(ranks, pods, d)]
    over = alike_against_reference(results, reference, pods, d)
    if mesh == (2, 2):
        assert any(over), "the reference stays within its own bound"


@pytest.mark.parametrize("mesh", MESHES)
def test_error_feedback_two_axis_matches_reference(ranks, reference, mesh):
    """Two steps of ``bf16×int8`` with error feedback on the composed
    schedule: the residuals (quantization on the first coded stage, bf16)
    are bit-exact with the reference's aggregator on every rank, and each
    step's mean is within the growth-aware bound of the exact mean of
    what was quantized, for the port and the reference alike."""
    pods, d = mesh
    p = pods * d
    results = _mesh(ranks, pods, d)
    g = _int_grads(p)
    buckets = results[0][("ef",)]["buckets"]
    prev = [np.zeros_like(_flat(g, keys)) for keys in buckets]
    for step in (1, 2):
        for i, keys in enumerate(buckets):
            want = reference[f"{pods}x{d}|agg|res{step}|{i}"]
            for rank, res in enumerate(results):
                got = res[("ef",)][step]["residuals"][i]
                assert np.array_equal(got.view(np.uint32).ravel(),
                                      want[rank].view(np.uint32).ravel()), \
                    f"step {step} rank {rank} bucket {keys}: residual"
            new = np.stack([r.ravel() for r in want]).astype(np.float64)
            sent = _flat(g, keys) + prev[i] - new     # q(g + r), per rank
            if step == 1:
                assert np.any(new != 0), "error feedback quantized nothing"
            exact = sent.sum(axis=0) / p
            bound, _ = _bucket_bound(p, pods, d, ["q"], {"q": sent})
            for rank, res in enumerate(results):
                port = _flat({k: v[None] for k, v in
                              res[("ef",)][step]["grads"].items()}, keys)[0]
                ref = _flat({k: reference[f"{pods}x{d}|agg|ef{step}|{k}"]
                             for k in keys}, keys)[rank]
                assert float(np.max(np.abs(port - exact))) <= bound, \
                    f"step {step} rank {rank} {keys}: port"
                assert float(np.max(np.abs(ref - exact))) <= bound, \
                    f"step {step} rank {rank} {keys}: reference"
                assert np.array_equal(
                    port, _flat({k: v[None] for k, v in results[0][("ef",)]
                                 [step]["grads"].items()}, keys)[0])
            prev[i] = new
