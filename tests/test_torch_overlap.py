"""Overlap: ``core/overlap.py`` and the in-backward channel against the
reference.

* Every function of the port's ``overlap.py`` equals the reference's
  ``repro/core/overlap.py`` float for float on the inputs of
  ``tests/test_overlap.py``.
* One spawn of 4 gloo ranks (file rendezvous) runs the reference's
  ``multidev_overlap_checks`` cases on integer-valued float32 gradients,
  for p = 3 (a subgroup) and 4: gradients reduced inside the backward
  (``overlap=True``) equal the post-backward path and a ``psum``
  aggregator bit for bit, also on a ``cuda_ipc`` view of the group and
  under ``strategy="auto"`` with a forced rhd + psum table; a leaf with
  no gradient reduces as zeros on both paths; and a reduced float32
  smollm-360m trains 2 steps with ``rhd_rsa`` + ``int8`` to the same
  parameters with and without overlap.
* A JAX subprocess with 4 host devices runs the reference's overlapped
  train step and ``overlap_params`` gradients from the same parameters
  and batches: the port's losses stay within 1e-3 and its overlapped
  gradients within ``codec.tolerance("int8", 4)``.
* On one rank: ``error_feedback`` with ``overlap`` raises, and a hook
  that does not fire or a channel that fails makes the step raise.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro.core import fusion as jfusion
from repro.core import overlap as joverlap
from repro.core import schedule as jschedule

from repro_torch import tree
from repro_torch.configs import get_spec
from repro_torch.convert import params_from_numpy
from repro_torch.core import AggregatorConfig, GradientAggregator, Group
from repro_torch.core import codec, dist, fusion, overlap, plan_cache
from repro_torch.core import schedule
from repro_torch.models import build_model, param_groups
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim import adamw
from repro_torch.train import TrainStepConfig, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4
LR = 1e-3
STEPS = 2
INT_MB = 0.02
LM_MB = 0.25


# ---------------------------------------------------------------------------
# overlap.py against the reference, function by function
# ---------------------------------------------------------------------------

def _plans(leaf_elems, threshold_bytes=64):
    jtree = {chr(ord("a") + i): jnp.zeros((n,), jnp.float32)
             for i, n in enumerate(leaf_elems)}
    ttree = {chr(ord("a") + i): torch.zeros((n,))
             for i, n in enumerate(leaf_elems)}
    return (jfusion.build_plan(jtree, threshold_bytes),
            fusion.build_plan(ttree, threshold_bytes))


PLAN_CASES = [([4, 4, 4, 4], 32), ([10, 10, 10, 10], 1), ([900, 100], 1),
              ([3, 17, 5, 64, 1, 9], 48), ([0, 7, 300], 1 << 20)]


@pytest.mark.parametrize("elems,threshold", PLAN_CASES)
def test_readiness_and_ready_times_match_reference(elems, threshold):
    jplan, tplan = _plans(elems, threshold)
    assert overlap.readiness_order(tplan) == joverlap.readiness_order(jplan)
    assert overlap.leaf_backward_costs(tplan.leaves) == \
        joverlap.leaf_backward_costs(jplan.leaves)
    for backward_s in (1.0, 0.3, 2.0 / 3.0):
        assert overlap.bucket_ready_times(tplan, backward_s) == \
            joverlap.bucket_ready_times(jplan, backward_s)
    costs = [float(i + 1) ** 1.5 for i in range(len(elems))]
    assert overlap.bucket_ready_times(tplan, 0.7, costs) == \
        joverlap.bucket_ready_times(jplan, 0.7, costs)
    with pytest.raises(ValueError):
        overlap.bucket_ready_times(tplan, 1.0, costs=[1.0] * (len(elems) + 1))


def _pair_tasks(spec):
    return ([overlap.BucketTask(*t) for t in spec],
            [joverlap.BucketTask(*t) for t in spec])


SIM_CASES = {
    "full_hiding": ([(0, 1024, "rhd_rsa", 0.5, 0.1),
                     (1, 1024, "rhd_rsa", 0.1, 0.1)], 1.0, 0.5),
    "tail": ([(0, 1024, "rhd_rsa", 1.0, 0.3)], 1.0, 0.0),
    "serializes": ([(0, 1024, "rhd_rsa", 0.8, 0.3),
                    (1, 1024, "psum", 0.8, 0.3)], 1.0, 0.0),
    "idle": ([(0, 8, "rhd_rsa", 0.0, 0.1), (1, 8, "ring_rsa", 0.5, 0.1)],
             1.0, 0.0),
    "mixed": ([(0, 1, "rhd_rsa", 0.2, 0.4), (1, 2, "rhd_rsa", 0.9, 0.5),
               (2, 3, "psum", 0.95, 0.2), (3, 4, "rhd_rsa", 0.95, 0.01)],
              1.0, 0.25),
    "empty": ([], 1.0, 0.5),
}


def _same_timeline(a, b):
    assert a.to_dict() == b.to_dict()
    assert [(e.task.index, e.start_s, e.end_s, e.wait_s) for e in a.events] \
        == [(e.task.index, e.start_s, e.end_s, e.wait_s) for e in b.events]


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_simulate_matches_reference(case):
    spec, backward_s, serial_s = SIM_CASES[case]
    tt, jt = _pair_tasks(spec)
    _same_timeline(overlap.simulate(tt, backward_s, serial_s),
                   joverlap.simulate(jt, backward_s, serial_s))


def test_measured_timeline_accounts_as_simulate():
    """The measured channel's accounting is simulate's: fed simulate's
    own events it gives simulate's timeline."""
    tt, _ = _pair_tasks(SIM_CASES["mixed"][0])
    sim = overlap.simulate(tt, 1.0, 0.25)
    _same_timeline(overlap.measured_timeline(sim.events, 1.0, 0.25), sim)


@pytest.mark.parametrize("n,threshold", [(4e-7, 2), (0.05, 6), (4.0, 9)])
def test_simulate_schedule_matches_reference(n, threshold):
    """Attached and detached (JSON round-trip) schedules of the same
    leaves, under a fixed strategy and under ``auto``."""
    import jax
    from repro.core import AggregatorConfig as JConfig
    from repro.core import GradientAggregator as JAgg
    from repro.core import PlanCache as JCache
    jgrads = {f"w{i}": jax.ShapeDtypeStruct((4096 * (i + 1),), jnp.float32)
              for i in range(threshold)}
    tgrads = {f"w{i}": torch.empty((4096 * (i + 1),))
              for i in range(threshold)}
    for strategy in ("rhd_rsa", "auto"):
        jsched = JAgg(JConfig(strategy=strategy, fusion_threshold_mb=n),
                      ("data",), cache=JCache()).resolve(jgrads, (8,))
        tsched = GradientAggregator(
            AggregatorConfig(strategy=strategy, fusion_threshold_mb=n),
            ("data",), {"data": Group()}).resolve(tgrads, (8,))
        for compute_s in (0.01, 3.0):
            _same_timeline(overlap.simulate_schedule(tsched, compute_s),
                           joverlap.simulate_schedule(jsched, compute_s))
        assert overlap.schedule_tasks(tsched, 0.5) == [
            overlap.BucketTask(**dataclasses.asdict(t))
            for t in joverlap.schedule_tasks(jsched, 0.5)]
        _same_timeline(
            overlap.simulate_schedule(schedule.from_json(tsched.to_json()),
                                      3.0),
            joverlap.simulate_schedule(jschedule.from_json(jsched.to_json()),
                                       3.0))


@pytest.mark.parametrize("total,n,threshold", [
    (100.0, 10, 1000.0), (100.0, 10, 30.0), (100.0, 4, 0), (100.0, 0, 10.0),
    (97.0, 7, 30.0), (102.2e6, 161, 4 * 2 ** 20)])
def test_model_timelines_match_reference(total, n, threshold):
    assert overlap.fused_bucket_bytes(total, n, threshold) == \
        joverlap.fused_bucket_bytes(total, n, threshold)

    def lat(b):
        return 5e-6 * 8 + 2 * b / 8e9

    tasks = overlap.model_tasks(total, n, threshold, 0.07, lat, "rhd_rsa")
    assert tasks == [overlap.BucketTask(**dataclasses.asdict(t)) for t in
                     joverlap.model_tasks(total, n, threshold, 0.07, lat,
                                          "rhd_rsa")]
    _same_timeline(overlap.model_timeline(total, n, threshold, 0.1, lat),
                   joverlap.model_timeline(total, n, threshold, 0.1, lat))
    assert overlap.BACKWARD_FRACTION == joverlap.BACKWARD_FRACTION


# ---------------------------------------------------------------------------
# The channel on gloo ranks
# ---------------------------------------------------------------------------

def _int_params(p):
    """Several small fused leaves and one large bucket; leading dims are
    multiples of p so no reducer padding blurs equality."""
    return {"a": torch.ones((p * 8, 3)), "b": torch.ones((p * 4,)),
            "w": torch.ones((p * 12288,))}


def _int_loss(params, x):
    """Per-rank gradients are integer-valued float32 (``s + arange``):
    every summation order is exact, so bit equality is the bar."""
    s = x.sum()
    total = torch.zeros(())
    for k in sorted(params):
        if k == "unused":
            continue
        v = params[k]
        coeff = s + torch.arange(v.numel(), dtype=torch.float32) \
            .reshape(v.shape)
        total = total + (v * coeff).sum()
    return total


def _int_grads(cfg, group, p, x, unused=False):
    params = {k: v.requires_grad_() for k, v in _int_params(p).items()}
    if unused:
        params["unused"] = torch.ones((5,), requires_grad=True)
    agg = GradientAggregator(cfg, ("data",), {"data": group},
                             cache=plan_cache.PlanCache())
    if cfg.overlap:
        run = agg.overlap_params(params)
        grads = run.backward(_int_loss(params, x))
    else:
        _int_loss(params, x).backward()
        grads = agg(tree.tree_map(
            lambda q: torch.zeros_like(q) if q.grad is None else q.grad,
            params))
    out = {k: g.detach().numpy().copy() for k, g in grads.items()}
    rec = agg.last_overlap
    return out, {"strategies": agg.last_schedule.strategies(),
                 "n_buckets": agg.last_schedule.n_buckets,
                 "order": agg.last_schedule.readiness_order(),
                 "record": None if rec is None else {
                     "channel": [b.index for b in rec.buckets],
                     "times": [(b.ready_s, b.start_s, b.end_s)
                               for b in rec.buckets],
                     "backward_s": rec.backward_s,
                     "traffic": rec.traffic,
                     "zero_leaves": rec.zero_leaves}}


def _table(p):
    return {"schema": "repro/allreduce-tuning/v1", "entries": [
        {"p": p, "bytes": 0, "latency_us": {"rhd_rsa": 1.0, "psum": 5.0}},
        {"p": p, "bytes": 32 * 1024,
         "latency_us": {"psum": 1.0, "rhd_rsa": 5.0}}]}


def _nest(flat: dict) -> dict:
    root: dict = {}
    for path, v in flat.items():
        node = root
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return root


def _lm_spec():
    return dataclasses.replace(get_spec("smollm-360m").reduced(),
                               dtype="float32")


def _lm_cfg(overlap_on):
    return AggregatorConfig(strategy="rhd_rsa", codec="int8",
                            fusion_threshold_mb=LM_MB, overlap=overlap_on)


def _lm_runs(rank, init_flat, batches):
    """2 steps of the reduced smollm with and without overlap, then one
    overlapped backward's reduced gradients from the initial
    parameters."""
    tokens, labels = batches
    spec = _lm_spec()
    out = {}
    for overlap_on in (False, True):
        module = TransformerLM(spec, params_from_numpy(_nest(init_flat)))
        opt = adamw(LR)
        step, extras = make_train_step(
            build_model(spec), opt,
            TrainStepConfig(aggregator=_lm_cfg(overlap_on)),
            groups={"data": Group()}, device="cpu")
        params = module.tree()
        state = opt.init(params)
        losses = []
        for i in range(STEPS):
            params, state, m = step(params, state, {
                "tokens": torch.from_numpy(tokens[i]),
                "labels": torch.from_numpy(labels[i])})
            losses.append(float(m["loss"]))
        rec = extras["aggregator"].last_overlap
        out[overlap_on] = {
            "losses": losses,
            "params": {"/".join(map(str, path)): q.detach().numpy().copy()
                       for path, q in tree.leaves_with_path(params)},
            "channel": None if rec is None else
            [b.index for b in rec.buckets],
            "order": extras["aggregator"].last_schedule.readiness_order()}
    module = TransformerLM(spec, params_from_numpy(_nest(init_flat)))
    params = module.tree()
    agg = GradientAggregator(_lm_cfg(True), ("data",), {"data": Group()})
    run = agg.overlap_params(params, groups=param_groups(params))
    per = tokens.shape[1] // P
    shard = {"tokens": torch.from_numpy(tokens[0][rank * per:(rank + 1)
                                                  * per]),
             "labels": torch.from_numpy(labels[0][rank * per:(rank + 1)
                                                  * per])}
    loss, _ = build_model(spec).loss(params, shard)
    grads = run.backward(loss)
    paths = ["/".join(map(str, path))
             for path, _ in tree.leaves_with_path(grads)]
    out["grads"] = {k: g.detach().numpy().copy()
                    for k, g in zip(paths, tree.leaves(grads))}
    # Each leaf's bucket's local absmax: the int8 codec's error bound is
    # relative to the fused bucket it encodes.
    local = [q.grad for q in tree.leaves(params)]
    out["bucket_absmax"] = {}
    for b in run.sched.buckets:
        idx = run.sched.plan.buckets[b.index].leaf_indices
        m = max(float(local[i].abs().max()) for i in idx)
        out["bucket_absmax"].update({paths[i]: m for i in idx})
    return out


def _rank_cases(rank, world, table_dir, init_flat, batches):
    torch.set_num_threads(1)
    res = {}
    pg3 = tdist.new_group([0, 1, 2])
    for p in (3, 4):
        if rank >= p:
            continue
        group = Group(pg3) if p == 3 else Group()
        x = torch.arange(p * 4, dtype=torch.float32)[rank * 4:(rank + 1) * 4]
        rhd = dict(strategy="rhd_rsa", fusion_threshold_mb=INT_MB)
        res[p] = {
            "overlap": _int_grads(AggregatorConfig(**rhd, overlap=True),
                                  group, p, x),
            "post": _int_grads(AggregatorConfig(**rhd), group, p, x),
            "psum": _int_grads(AggregatorConfig(
                strategy="psum", fusion_threshold_mb=INT_MB), group, p, x)}
        path = os.path.join(table_dir, f"table{p}.json")
        res[p]["auto"] = _int_grads(AggregatorConfig(
            strategy="auto", selector_mode="empirical", selector_table=path,
            fusion_threshold_mb=INT_MB, overlap=True), group, p, x)
        if p == 4:
            ipc = Group(transport="cuda_ipc")
            res[p]["overlap_ipc"] = _int_grads(
                AggregatorConfig(**rhd, overlap=True), ipc, p, x)
            res[p]["auto_ipc"] = _int_grads(AggregatorConfig(
                strategy="auto", selector_mode="empirical",
                selector_table=path, fusion_threshold_mb=INT_MB,
                overlap=True), ipc, p, x)
            for label, ov in (("unused_overlap", True),
                              ("unused_post", False)):
                res[p][label] = _int_grads(
                    AggregatorConfig(**rhd, overlap=ov), group, p, x,
                    unused=True)
    plan_cache.GLOBAL_EXECUTOR_CACHE.clear()   # closes the cuda_ipc slots
    res["lm"] = _lm_runs(rank, init_flat, batches)
    return res


_JAX_SCRIPT = r"""
import dataclasses, sys
sys.path.insert(0, sys.argv[1])
from devflags import force_host_devices
force_host_devices(4)
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_spec
from repro.core import AggregatorConfig, GradientAggregator, PlanCache
from repro.core.compat import make_mesh, shard_map
from repro.models import build_model
from repro.optim import adamw
from repro.train import TrainStepConfig, make_train_step

out_dir, lr, steps = sys.argv[2], float(sys.argv[3]), int(sys.argv[4])
spec = dataclasses.replace(get_spec("smollm-360m").reduced(), dtype="float32")
model = build_model(spec)
init = model.init(jax.random.PRNGKey(0))
flat = jax.tree_util.tree_flatten_with_path(init)[0]
key = lambda path: "/".join(k.key for k in path)
np.savez(f"{out_dir}/init.npz", **{key(p): np.asarray(v) for p, v in flat})
data = np.load(f"{out_dir}/batches.npz")
mesh = make_mesh((4,), ("data",))
agg_cfg = AggregatorConfig(strategy="rhd_rsa", codec="int8",
                           fusion_threshold_mb=float(sys.argv[5]),
                           overlap=True)
opt = adamw(lr)
tokens, labels = data["tokens"], data["labels"]
step, _ = make_train_step(model, opt, mesh, TrainStepConfig(aggregator=agg_cfg),
                          {"tokens": tokens[0], "labels": labels[0]},
                          donate=False)
params, state, losses = init, opt.init(init), []
for i in range(steps):
    params, state, m = step(params, state, {"tokens": tokens[i],
                                            "labels": labels[i]})
    losses.append(float(m["loss"]))
res = {"losses": np.asarray(losses)}
agg = GradientAggregator(agg_cfg, ("data",), cache=PlanCache())

def local(p, t, l):
    return jax.grad(lambda q: model.loss(agg.overlap_params(q),
                                         {"tokens": t, "labels": l})[0])(p)

fn = jax.jit(shard_map(local, mesh, in_specs=(P(), P("data"), P("data")),
                       out_specs=P(), axis_names={"data"}, check_vma=False))
grads = fn(init, tokens[0], labels[0])
for p_, v in jax.tree_util.tree_flatten_with_path(grads)[0]:
    res["grads|" + key(p_)] = np.asarray(v)
np.savez(f"{out_dir}/out.npz", **res)
print("JAX OVERLAP DONE")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("jaxoverlap")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (STEPS, 4, 33)).astype(np.int32)
    np.savez(d / "batches.npz", tokens=toks[:, :, :-1],
             labels=toks[:, :, 1:])
    script = d / "ref.py"
    script.write_text(_JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(script), os.path.join(ROOT, "tests"), str(d),
         str(LR), str(STEPS), str(LM_MB)], capture_output=True, text=True,
        timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "JAX OVERLAP DONE" in proc.stdout
    return (dict(np.load(d / "init.npz")), dict(np.load(d / "out.npz")),
            (toks[:, :, :-1], toks[:, :, 1:]))


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    init, _, batches = reference
    d = tmp_path_factory.mktemp("overlap_tables")
    for p in (3, 4):
        with open(d / f"table{p}.json", "w") as f:
            json.dump(_table(p), f)
    return dist.run_ranks(_rank_cases, P, (str(d), init, batches),
                          rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
                          threads=1, timeout_s=400)


def _expected_int(p):
    """The exact mean of the ranks' integer gradients, scaled as the
    aggregator scales (one float32 multiply by 1/p)."""
    s_total = float(sum(np.arange(p * 4, dtype=np.float64)))
    out = {}
    for k, v in _int_params(p).items():
        n = v.numel()
        total = (s_total + p * np.arange(n, dtype=np.float64)) \
            .astype(np.float32)
        out[k] = (total * np.float32(1.0 / p)).reshape(tuple(v.shape))
    return out


def _bits(a, b):
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("p", [3, 4])
def test_overlap_bitexact_with_post_backward_and_psum(ranks, p):
    for r in ranks[:p]:
        got, meta = r[p]["overlap"]
        assert meta["n_buckets"] >= 2
        assert _bits(got, r[p]["post"][0])
        assert _bits(got, r[p]["psum"][0])
        assert _bits(got, _expected_int(p))


def test_overlap_on_cuda_ipc_matches_gloo(ranks):
    """Also the mixed rhd + psum schedule, whose executor sizes the
    slots from the rhd bucket alone (psum has no hop)."""
    for r in ranks:
        for label, base in (("overlap_ipc", "overlap"), ("auto_ipc", "auto")):
            assert _bits(r[4][label][0], r[4][base][0])
            assert r[4][label][1]["record"]["traffic"][
                "control_messages"] > 0
        assert r[4]["auto_ipc"][1]["strategies"] == ("psum", "rhd_rsa")


@pytest.mark.parametrize("p", [3, 4])
def test_overlap_mixed_auto_schedule_bitexact(ranks, p):
    """``strategy="auto"`` under a forced table mixes rhd (the small
    fused bucket) and psum (the large one) inside the backward."""
    for r in ranks[:p]:
        got, meta = r[p]["auto"]
        assert meta["strategies"] == ("psum", "rhd_rsa")
        assert _bits(got, r[p]["psum"][0])


@pytest.mark.parametrize("p", [3, 4])
def test_channel_takes_buckets_in_readiness_order(ranks, p):
    for r in ranks[:p]:
        for label in ("overlap", "auto"):
            meta = r[p][label][1]
            rec = meta["record"]
            assert tuple(rec["channel"]) == meta["order"]
            for ready, start, end in rec["times"]:
                assert 0.0 <= ready <= start <= end
            starts = [t[1] for t in rec["times"]]
            assert starts == sorted(starts)
            assert rec["traffic"]["staged_bytes"] == 0


def test_leaf_without_gradient_reduces_as_zeros(ranks):
    for r in ranks:
        ov, meta = r[4]["unused_overlap"]
        post, _ = r[4]["unused_post"]
        assert _bits(ov, post)
        assert np.array_equal(ov["unused"], np.zeros(5, np.float32))
        assert _bits({k: v for k, v in ov.items() if k != "unused"},
                     r[4]["overlap"][0])
        assert meta["record"]["zero_leaves"] == (2,)   # a, b, unused, w


def test_train_step_overlap_matches_post_backward_bits(ranks):
    for r in ranks:
        on, off = r["lm"][True], r["lm"][False]
        assert on["losses"] == off["losses"]
        assert _bits(on["params"], off["params"])
        assert tuple(on["channel"]) == on["order"]
    for r in ranks[1:]:
        assert _bits(r["lm"][True]["params"], ranks[0]["lm"][True]["params"])


def test_train_step_overlap_losses_match_reference(ranks, reference):
    _, out, _ = reference
    np.testing.assert_allclose(ranks[0]["lm"][True]["losses"],
                               out["losses"], rtol=1e-3)


def test_overlapped_gradients_within_codec_tolerance_of_reference(
        ranks, reference):
    """Both sides' int8 sums lie within ``codec.tolerance`` of the exact
    sum of the ranks' gradients, relative to the absmax of the fused
    bucket each leaf travels in, so the two means lie within twice that,
    over p.  The bound is per bucket, so a bucket reduced to zeros or
    into the wrong leaves fails."""
    _, out, _ = reference
    tol = codec.tolerance("int8", P)
    got = ranks[0]["lm"]["grads"]
    assert sorted(got) == sorted(k[len("grads|"):] for k in out
                                 if k.startswith("grads|"))
    assert sorted(ranks[0]["lm"]["bucket_absmax"]) == sorted(got)
    for path, v in got.items():
        absmax = max(r["lm"]["bucket_absmax"][path] for r in ranks)
        bound = 2 * tol * absmax / P
        err = float(np.abs(v - out["grads|" + path]).max())
        assert err <= bound, (path, err, bound)


# ---------------------------------------------------------------------------
# Refusals, on one rank
# ---------------------------------------------------------------------------

def test_error_feedback_with_overlap_raises():
    cfg = AggregatorConfig(codec="int8", error_feedback=True, overlap=True)
    with pytest.raises(ValueError, match="overlap"):
        cfg.validate()
    with pytest.raises(ValueError, match="overlap"):
        GradientAggregator(cfg, ("data",), {"data": Group()})


def _one_rank(**over):
    params = {k: v.requires_grad_() for k, v in _int_params(1).items()}
    agg = GradientAggregator(AggregatorConfig(
        strategy="rhd_rsa", fusion_threshold_mb=INT_MB, overlap=True,
        **over), ("data",), {"data": Group()}, cache=plan_cache.PlanCache())
    return params, agg


def test_hook_that_does_not_fire_raises():
    params, agg = _one_rank()
    run = agg.overlap_params(params)
    for h in agg._hooked[1]:
        h.remove()
    with pytest.raises(RuntimeError, match="hook did not fire"):
        run.backward(_int_loss(params, torch.ones(4)))
    assert not agg._run


def test_channel_failure_raises(monkeypatch):
    params, agg = _one_rank()
    run = agg.overlap_params(params)

    def fail(*a, **k):
        raise RuntimeError("transport lost")

    monkeypatch.setattr(run.executor, "reduce_bucket", fail)
    with pytest.raises(RuntimeError, match="overlap channel failed"):
        run.backward(_int_loss(params, torch.ones(4)))
    # the aggregator is usable again, and reduces as before
    for q in params.values():
        q.grad = None
    monkeypatch.undo()
    run = agg.overlap_params(params)
    grads = run.backward(_int_loss(params, torch.ones(4)))
    assert float(grads["b"][0]) == 4.0


def test_accumulated_gradient_refused():
    params, agg = _one_rank()
    _int_loss(params, torch.ones(4)).backward()
    run = agg.overlap_params(params)
    with pytest.raises(RuntimeError, match="clear .grad"):
        run.backward(_int_loss(params, torch.ones(4)))


def test_channel_stress_many_buckets():
    """96 leaves in 40 buckets, a switch interval of a microsecond and
    20 overlapped backwards in a row, bounded in time: every bucket is
    reduced once, in readiness order, to the gradients' own bits (one
    rank: the reduction is the identity)."""
    params = {f"l{i:03d}": torch.arange(1.0, 2.0 + i % 7).requires_grad_()
              for i in range(96)}
    agg = GradientAggregator(AggregatorConfig(
        strategy="rhd_rsa", fusion_threshold_mb=48 / 2 ** 20, overlap=True),
        ("data",), {"data": Group()}, cache=plan_cache.PlanCache())
    failures = []

    def work():
        try:
            for step in range(20):
                x = torch.full((4,), float(step))
                run = agg.overlap_params(params)
                grads = run.backward(_int_loss(params, x))
                rec, sched = agg.last_overlap, agg.last_schedule
                assert tuple(b.index for b in rec.buckets) == \
                    sched.readiness_order()
                assert sched.n_buckets == 40
                for k, q in params.items():
                    assert torch.equal(grads[k], q.grad), k
                    q.grad = None
        except BaseException as e:
            failures.append(e)
            raise

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        worker = threading.Thread(target=work, daemon=True)
        worker.start()
        worker.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not worker.is_alive(), "the overlapped backwards did not finish"
    assert not failures, failures
