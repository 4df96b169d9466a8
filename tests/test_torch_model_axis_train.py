"""The model axis on gloo ranks against the reference.

One spawn of 8 gloo ranks (file rendezvous) lays out a 2 × 2 × 2
``("pod", "data", "model")`` mesh (all eight, ``launch.mesh.
make_groups``), a 2 × 2 ``("data", "model")`` mesh (ranks 0-3, the same
layout) and a 4 × 2 pod × data mesh (all eight).  One JAX subprocess
with 8 host devices runs the reference on the same meshes from the same
numpy inputs, while the ranks run.  Checks:

* the reference wall's first check: the aggregator with the model
  bracket (``ring@data×rhd@pod×ag@model``; ``rhd@data×ag@model`` on
  2 × 2) on integer-valued gradients is bit-exact with a dp ``psum``,
  with the exact mean and with the reference's bracket, on gloo and on
  ``cuda_ipc`` (shared memory here; a channel for the model axis sized
  to its own all-gather);
* the gather boundary: forward gives the full leaves, backward this
  rank's block of the cotangent (no sum); ``shard_params`` and
  ``convert.shard_from_numpy`` / ``join_shards`` agree with it;
* 3 steps of the reduced float32 smollm-360m through the port's
  full-manual ``make_train_step`` against the reference's
  ``make_train_step`` on the same mesh, at ``test_torch_train_step.py``'s
  tolerances: uncoded ``rhd_rsa`` on 2 × 2 × 2 and 2 × 2, and
  ``rhd_rsa`` + ``int8`` (fused hops; the codec skips the bracket) on
  2 × 2 × 2; every dp replica holds the same shards, model ranks take
  the same rows;
* the launcher's rank entry on ``--mesh 2x2x2``;
* F6's 4 × 2 witness: the coded composed aggregator on alike inputs
  (two RHD doubling hops, the second joining blocks decoded at two
  scales) no worse than the reference, bucket by bucket
  (``test_torch_two_axis_reducers.alike_against_reference``).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert, tree
from repro_torch.configs import get_spec
from repro_torch.core import (AggregatorConfig, GradientAggregator, dist,
                              manual, plan_cache)
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_groups
from repro_torch.models import build_model
from repro_torch.models.common import ParamTree
from repro_torch.optim import adamw
from repro_torch.train import TrainStepConfig, make_train_step
from repro_torch.train.step import shard_batch

from test_torch_train_step import _check_uncoded, _nest
from test_torch_two_axis_reducers import (_agg_run, _int_loss,
                                          alike_against_reference)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
STEPS = 3
LR = 1e-3
INT_MB = 0.02
# label -> (pods, data, model); pods 0: one data axis
MESHES = {"2x2x2": (2, 2, 2), "2x2": (0, 2, 2)}
# (run, mesh, strategy, codec)
RUNS = (("none", "2x2x2", "rhd_rsa", "none"),
        ("int8", "2x2x2", "rhd_rsa", "int8"),
        ("none", "2x2", "rhd_rsa", "none"))
BRACKET = {"2x2x2": ("ring_rsa×rhd_rsa", "ring@data×rhd@pod×ag@model"),
           "2x2": ("rhd_rsa", "rhd@data×ag@model")}
ALIKE = (4, 2)                           # F6's pods × data


def _dp_axes(mesh):
    return ("pod", "data") if MESHES[mesh][0] else ("data",)


def _dp_size(mesh):
    pods, d, _ = MESHES[mesh]
    return max(pods, 1) * d


def _spec():
    return dataclasses.replace(get_spec("smollm-360m").reduced(),
                               dtype="float32")


def _batches():
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 512, (STEPS, 8, 33)).astype(np.int32)
    return toks[:, :, :-1], toks[:, :, 1:]


def _bracket_params():
    """The reference wall's leaves: neither the ring chunks, the model
    shard nor the RHD fold pads."""
    return {"a": torch.ones((64, 3)), "b": torch.ones((64,)),
            "w": torch.ones((12288,))}


def _gather_leaves():
    rng = np.random.default_rng(11)
    full = {"embed": rng.standard_normal((16, 6)).astype(np.float32),
            "wq": rng.standard_normal((2, 6, 12)).astype(np.float32),
            "ln": rng.standard_normal((6,)).astype(np.float32)}
    ct = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in full.items()}
    specs = {"embed": ("model", None), "wq": (None, None, "model"),
             "ln": ()}
    return full, ct, specs


def _mesh_groups(mesh, transport=None):
    """This rank's groups on ``mesh``: the whole world through
    ``make_groups``; the 2 × 2 data × model mesh over ranks 0-3 in the
    same layout (every rank creates every subgroup, in one order), ``{}``
    on the ranks outside it."""
    pods, d, m = MESHES[mesh]
    if pods:
        return make_groups(pods, d, m, transport=transport)
    rank = torch.distributed.get_rank()
    mine = {}
    for ax, lists in (("data", [[j * m + i for j in range(d)]
                                for i in range(m)]),
                      ("model", [[j * m + i for i in range(m)]
                                 for j in range(d)])):
        for members in lists:
            pg = torch.distributed.new_group(members)
            if rank in members:
                mine[ax] = pg
    if rank >= d * m:
        return {}
    return {ax: dist.Group(mine[ax], name=ax, transport=transport)
            for ax in ("data", "model")}


def _dp_index(groups, mesh):
    index = 0
    for ax in _dp_axes(mesh):
        index = index * groups[ax].size + groups[ax].rank
    return index


def _bracket_case(mesh, groups, transport):
    strategy, _ = BRACKET[mesh]
    dp_axes = _dp_axes(mesh)
    x = torch.arange(_dp_size(mesh) * 4, dtype=torch.float32)
    i = _dp_index(groups, mesh)
    out = {}
    for label, cfg, model_axis in (
            ("bracket", AggregatorConfig(strategy=strategy,
                                         fusion_threshold_mb=INT_MB),
             "model"),
            ("psum", AggregatorConfig(strategy="psum",
                                      fusion_threshold_mb=INT_MB), None)):
        if transport == "cuda_ipc" and label == "psum":
            continue
        params = {k: v.requires_grad_() for k, v in _bracket_params().items()}
        _int_loss(params, x[i * 4:(i + 1) * 4]).backward()
        agg = GradientAggregator(cfg, dp_axes, groups,
                                 cache=plan_cache.PlanCache(),
                                 model_axis=model_axis)
        grads = agg({k: p.grad for k, p in params.items()})
        sched = agg.last_schedule
        ex = plan_cache.GLOBAL_EXECUTOR_CACHE.executor_for(sched, agg.groups,
                                                           "cpu")
        out[label] = {
            "grads": {k: g.numpy().copy() for k, g in grads.items()},
            "render": [b.render() for b in sched.buckets],
            "json": sched.to_json(),
            "slots": {ch.group.name: ch.slot_bytes for ch in ex.channels}}
    return out


def _gather_case(groups):
    full, ct, specs = _gather_leaves()
    g = groups["model"]
    shards = convert.shard_from_numpy(full, specs, g.rank, g.size)
    params = tree.tree_map(lambda t: t.requires_grad_(), shards)
    gathered = manual.gather_params(params, specs, g)
    loss = sum((v * torch.from_numpy(ct[k])).sum()
               for k, v in gathered.items())
    loss.backward()
    ref = manual.shard_params(convert.params_from_numpy(full), specs, g)
    return {"full": {k: v.detach().numpy().copy()
                     for k, v in gathered.items()},
            "grad": {k: p.grad.numpy().copy() for k, p in params.items()},
            "shard": {k: v.detach().numpy().copy() for k, v in
                      params.items()},
            "shard_params": {k: v.numpy().copy() for k, v in ref.items()}}


def _train_case(mesh, strategy, codec, groups, init_flat):
    spec = _spec()
    model = build_model(spec)
    opt = adamw(LR)
    cfg = TrainStepConfig(aggregator=AggregatorConfig(
        strategy=strategy, codec=codec, fusion_threshold_mb=0.25),
        dp_axes=_dp_axes(mesh))
    step, extras = make_train_step(model, opt, cfg, groups=groups,
                                   device="cpu")
    seen = {"gnorms": [], "grad1": None}

    def inspect(reduced, gnorm):
        seen["gnorms"].append(float(gnorm))
        if seen["grad1"] is None:
            seen["grad1"] = {"/".join(path): x.detach().numpy().copy()
                             for path, x in tree.leaves_with_path(reduced)}

    extras["inspect"] = inspect
    g = extras["model_group"]
    params = ParamTree(convert.shard_from_numpy(
        _nest(init_flat), extras["mspecs"], g.rank, g.size)).tree()
    state = opt.init(params)
    tokens, labels = _batches()
    losses, norms = [], []
    for i in range(STEPS):
        params, state, metrics = step(params, state, {
            "tokens": torch.from_numpy(tokens[i]),
            "labels": torch.from_numpy(labels[i])})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    rows = shard_batch({"tokens": torch.from_numpy(tokens[0])},
                       [groups[a] for a in _dp_axes(mesh)])["tokens"]
    return {"losses": losses, "grad_norms": norms, "inspected": seen,
            "render": extras["aggregator"].last_schedule.render(),
            "rows": rows.numpy().copy(),
            "shards": {"/".join(path): p.detach().numpy().copy()
                       for path, p in tree.leaves_with_path(params)},
            "mspecs": {"/".join(path): s for path, s in
                       tree.leaves_with_path(extras["mspecs"])}}


def _rank_cases(rank, world, init_flat):
    torch.set_num_threads(1)
    out = {}
    for mesh in MESHES:
        groups = _mesh_groups(mesh)
        ipc = _mesh_groups(mesh, transport="cuda_ipc")
        if not groups:
            continue
        out[("bracket", mesh)] = _bracket_case(mesh, groups, "gloo")
        out[("bracket_ipc", mesh)] = _bracket_case(mesh, ipc, "cuda_ipc")
        out[("gather", mesh)] = _gather_case(groups)
        for run, rmesh, strategy, codec in RUNS:
            if rmesh == mesh:
                out[(run, mesh)] = _train_case(mesh, strategy, codec, groups,
                                               init_flat)
        out[("coords", mesh)] = {ax: (g.rank, g.size)
                                 for ax, g in groups.items()}
        plan_cache.GLOBAL_EXECUTOR_CACHE.clear()    # closes the channels
    pods, d = ALIKE
    xs = torch.arange(pods * d * 4, dtype=torch.float32)[rank * 4:
                                                         (rank + 1) * 4]
    out["alike"] = _agg_run(AggregatorConfig(
        strategy="ring_rsa×rhd_rsa", codec="bf16×int8",
        fusion_threshold_mb=INT_MB), make_groups(pods, d), pods * d, xs)
    args = launch_train.parser().parse_args(
        ["--arch", "smollm-360m", "--mesh", "2x2x2", "--device", "cpu",
         "--steps", "2", "--batch", "8", "--seq", "16",
         "--strategy", "ring_rsa×rhd_rsa", "--log-every", "1"])
    out["launcher"] = launch_train._rank_main(rank, world, args)
    return out


_JAX_SCRIPT = r"""
import dataclasses, sys
sys.path.insert(0, sys.argv[1])
from devflags import force_host_devices
force_host_devices(8)
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_spec
from repro.core import AggregatorConfig, GradientAggregator, PlanCache
from repro.core.compat import make_mesh, shard_map
from repro.models import build_model
from repro.optim import adamw
from repro.train import TrainStepConfig, make_train_step

out_dir, lr, int_mb = sys.argv[2], float(sys.argv[3]), float(sys.argv[4])
runs = [r.split(":") for r in sys.argv[5].split(",")]
meshes = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
bracket = {"2x2x2": "ring_rsa×rhd_rsa", "2x2": "rhd_rsa"}
out = {}


def int_loss(params, x):
    s = jnp.sum(x)
    total = 0.0
    for k in sorted(params):
        v = params[k]
        coeff = s + jnp.arange(v.size, dtype=jnp.float32).reshape(v.shape)
        total = total + jnp.sum(v * coeff)
    return total


def mesh_of(name):
    shape, axes = meshes[name]
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


# The wall's first check: the bracketed aggregator on integer gradients.
for name in meshes:
    mesh = mesh_of(name)
    dp = tuple(a for a in mesh.axis_names if a != "model")
    agg = GradientAggregator(AggregatorConfig(strategy=bracket[name],
                                              fusion_threshold_mb=int_mb),
                             dp, cache=PlanCache(), model_axis="model")
    fn = jax.jit(shard_map(lambda p, x: agg(jax.grad(int_loss)(p, x)), mesh,
                           in_specs=(P(), P(dp)), out_specs=P(),
                           axis_names=None, check_vma=False))
    params = {"a": jnp.ones((64, 3)), "b": jnp.ones((64,)),
              "w": jnp.ones((12288,))}
    dp_size = int(np.prod([mesh.shape[a] for a in dp]))
    got = fn(params, jnp.arange(dp_size * 4, dtype=jnp.float32))
    for k, v in got.items():
        out[f"bracket|{name}|{k}"] = np.asarray(v)

# Three steps of the reduced float32 smollm-360m.
spec = dataclasses.replace(get_spec("smollm-360m").reduced(), dtype="float32")
model = build_model(spec)
init = model.init(jax.random.PRNGKey(0))
flat = jax.tree_util.tree_flatten_with_path(init)[0]
key = lambda path: "/".join(k.key for k in path)
np.savez(f"{out_dir}/init.npz", **{key(p): np.asarray(v) for p, v in flat})
print("INIT WRITTEN", flush=True)
data = np.load(f"{out_dir}/batches.npz")
tokens, labels = data["tokens"], data["labels"]
for run, name, strategy, codec in runs:
    mesh = make_mesh(*meshes[name])
    dp = tuple(a for a in mesh.axis_names if a != "model")
    opt = adamw(lr)
    cfg = TrainStepConfig(aggregator=AggregatorConfig(
        strategy=strategy, codec=codec, fusion_threshold_mb=0.25),
        dp_axes=dp)
    step, sh = make_train_step(model, opt, mesh, cfg,
                               {"tokens": tokens[0], "labels": labels[0]},
                               donate=False)
    params, state, losses = init, opt.init(init), []
    for i in range(tokens.shape[0]):
        params, state, m = step(params, state, {
            "tokens": tokens[i], "labels": labels[i]})
        losses.append(float(m["loss"]))
    tag = f"{run}@{name}"
    out[f"{tag}|losses"] = np.asarray(losses)
    out[f"{tag}|render"] = np.asarray(sh["aggregator"].last_schedule.render())
    for p, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[f"{tag}|{key(p)}"] = np.asarray(v)

# F6's 4 x 2 witness: the coded composed aggregator on alike gradients.
pods, d = 4, 2
mesh = Mesh(np.array(jax.devices()).reshape(pods, d), ("pod", "data"))
agg = GradientAggregator(AggregatorConfig(
    strategy="ring_rsa×rhd_rsa", codec="bf16×int8",
    fusion_threshold_mb=int_mb), ("pod", "data"), cache=PlanCache())
fn = jax.jit(shard_map(
    lambda p, x: jax.tree_util.tree_map(lambda a: a[None],
                                        agg(jax.grad(int_loss)(p, x))),
    mesh, in_specs=(P(), P(("pod", "data"))), out_specs=P(("pod", "data")),
    check_vma=False))
p = pods * d
got = fn({"a": np.ones((p * 32, 3), np.float32),
          "b": np.ones((p * 32,), np.float32),
          "w": np.ones((p * 12288,), np.float32)},
         np.arange(p * 4, dtype=np.float32))
for k, v in got.items():
    out[f"{pods}x{d}|agg|coded|{k}"] = np.asarray(v)
np.savez(f"{out_dir}/out.npz", **out)
print("JAX MODEL-AXIS DONE")
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX subprocess, started first; the ranks start once it has
    written the initial parameters, and run while it trains."""
    d = tmp_path_factory.mktemp("jax_model_axis")
    tokens, labels = _batches()
    np.savez(d / "batches.npz", tokens=tokens, labels=labels)
    script = d / "ref.py"
    script.write_text(_JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["REPRO_TEST_DEVICES"] = str(WORLD)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, str(script), os.path.join(ROOT, "tests"), str(d),
         str(LR), str(INT_MB), ",".join(":".join(r) for r in RUNS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        for line in proc.stdout:
            if line.startswith("INIT WRITTEN"):
                break
        init = dict(np.load(d / "init.npz"))
        port = dist.run_ranks(
            _rank_cases, WORLD, (init,),
            rendezvous_dir=str(tmp_path_factory.mktemp("rdv")), threads=1,
            timeout_s=300)
        rest, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    assert "JAX MODEL-AXIS DONE" in rest
    return init, dict(np.load(d / "out.npz")), port


def _mesh_ranks(port, mesh):
    pods, d, m = MESHES[mesh]
    return port[:max(pods, 1) * d * m]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_coordinates(both, mesh):
    """Rank ``r = (pod·d + data)·m + model``."""
    _, _, port = both
    pods, d, m = MESHES[mesh]
    for r, res in enumerate(_mesh_ranks(port, mesh)):
        coords = res[("coords", mesh)]
        assert coords["model"] == (r % m, m)
        assert coords["data"] == ((r // m) % d, d)
        if pods:
            assert coords["pod"] == (r // (m * d), pods)


@pytest.mark.parametrize("transport", ["bracket", "bracket_ipc"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_bracket_bit_exact_with_psum_and_reference(both, mesh, transport):
    _, out, port = both
    _, render = BRACKET[mesh]
    n = _dp_size(mesh)
    s_total = float(np.arange(n * 4).sum())
    for r, res in enumerate(_mesh_ranks(port, mesh)):
        got = res[(transport, mesh)]["bracket"]
        psum = res[("bracket", mesh)]["psum"]
        assert set(got["render"]) == {render}
        assert got["json"]["model_axis"] == "model"
        assert got["json"]["model_axis_size"] == 2
        for k, v in got["grads"].items():
            exact = ((s_total + n * np.arange(v.size, dtype=np.float64))
                     .astype(np.float32) * np.float32(1.0 / n)) \
                .reshape(v.shape)
            assert np.array_equal(v, psum["grads"][k]), (r, k)
            assert np.array_equal(v, exact), (r, k)
            # the reference returns the dp SUM's mean over dp ranks
            assert np.array_equal(v.view(np.uint32),
                                  out[f"bracket|{mesh}|{k}"]
                                  .view(np.uint32)), (r, k)


def test_model_axis_channel_sized_to_its_own_hops(both):
    """cuda_ipc: the model axis's all-gather hop carries the 1/m chunk
    of the largest bracketed bucket (``w``, 12,288 f32, its dp hops on
    the chunk: data half of it, pod half again)."""
    _, _, port = both
    for res in _mesh_ranks(port, "2x2x2"):
        slots = res[("bracket_ipc", "2x2x2")]["bracket"]["slots"]
        assert slots == {"model": 6144 * 4, "data": 3072 * 4,
                         "pod": 1536 * 4}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gather_boundary_forward_and_backward(both, mesh):
    _, _, port = both
    full, ct, specs = _gather_leaves()
    _, _, m = MESHES[mesh]
    shards = []
    for r, res in enumerate(_mesh_ranks(port, mesh)):
        got = res[("gather", mesh)]
        i = r % m
        for k, v in full.items():
            assert np.array_equal(got["full"][k], v), (r, k)
            dim = manual.sharded_dim(specs[k])
            want = ct[k] if dim is None else np.take(
                ct[k], range(i * v.shape[dim] // m,
                              (i + 1) * v.shape[dim] // m), axis=dim)
            assert np.array_equal(got["grad"][k], want), (r, k)
            assert np.array_equal(got["shard_params"][k], got["shard"][k])
        if len(shards) < m:
            shards.append(got["shard"])
    joined = convert.join_shards(shards, specs)
    for k, v in full.items():
        assert np.array_equal(joined[k], v)


def _joined(port, mesh, run):
    """Each dp replica's full parameters, joined from its model ranks'
    shards."""
    _, _, m = MESHES[mesh]
    ranks = _mesh_ranks(port, mesh)
    out = []
    for first in range(0, len(ranks), m):
        group = [ranks[first + i][(run, mesh)] for i in range(m)]
        specs = _nest(group[0]["mspecs"])
        out.append(tree.leaves_with_path(convert.join_shards(
            [_nest(g["shards"]) for g in group], specs)))
    return [{"/".join(p): v for p, v in rep} for rep in out]


def _reference(out, run, mesh):
    """The reference's results of ``run`` on ``mesh`` under the keys
    ``_check_uncoded`` reads (``{run}|losses``, ``{run}|<path>``)."""
    tag = f"{run}@{mesh}|"
    return {f"{run}|{k[len(tag):]}": v for k, v in out.items()
            if k.startswith(tag)}


@pytest.mark.parametrize("run,mesh", [("none", "2x2x2"), ("none", "2x2")])
def test_uncoded_steps_match_reference(both, run, mesh):
    _, out, port = both
    got = port[0][(run, mesh)]
    assert got["render"] == str(out[f"{run}@{mesh}|render"])
    assert "ag@model" in got["render"]
    for params in _joined(port, mesh, run):
        _check_uncoded({"losses": got["losses"], "params": params},
                       _reference(out, run, mesh), run, STEPS)


def test_int8_steps_match_reference(both):
    _, out, port = both
    got = port[0][("int8", "2x2x2")]
    assert got["render"] == str(out["int8@2x2x2|render"])
    assert "ag@model" not in got["render"]
    np.testing.assert_allclose(got["losses"], out["int8@2x2x2|losses"],
                               rtol=1e-3)


@pytest.mark.parametrize("run,mesh", [r[:2] for r in RUNS])
def test_replicas_and_rows(both, run, mesh):
    """Every dp replica holds the same parameters and losses; model
    ranks take the same rows of the global batch, dp ranks their own."""
    _, _, port = both
    reps = _joined(port, mesh, run)
    for rep in reps[1:]:
        for k, v in reps[0].items():
            assert np.array_equal(v, rep[k]), k
    _, _, m = MESHES[mesh]
    tokens, _ = _batches()
    per = tokens.shape[1] // _dp_size(mesh)
    for r, res in enumerate(_mesh_ranks(port, mesh)):
        got = res[(run, mesh)]
        assert got["losses"] == port[0][(run, mesh)]["losses"]
        i = r // m
        assert np.array_equal(got["rows"],
                              tokens[0][i * per:(i + 1) * per])


@pytest.mark.parametrize("run,mesh", [r[:2] for r in RUNS])
def test_step_inspect_sees_the_reduced_gradient(both, run, mesh):
    """The step's ``inspect`` hook gets each step's aggregated gradient
    (shards, before the clip) and the norm the clip used: the step's
    ``grad_norm`` metric, and on step 1 the plain norm of the gradient
    joined over the model ranks (the sharded clip sums each sharded
    leaf's squares over the model group and counts replicated leaves
    once)."""
    _, _, port = both
    _, _, m = MESHES[mesh]
    ranks = _mesh_ranks(port, mesh)
    for r, res in enumerate(ranks):
        got = res[(run, mesh)]
        np.testing.assert_allclose(got["inspected"]["gnorms"],
                                   got["grad_norms"], rtol=1e-6)
        if r % m:
            continue
        group = [ranks[r + i][(run, mesh)] for i in range(m)]
        specs = _nest(group[0]["mspecs"])
        full = convert.join_shards(
            [_nest(g["inspected"]["grad1"]) for g in group], specs)
        norm = np.sqrt(sum(np.sum(np.square(x.astype(np.float64)))
                           for x in tree.leaves(full)))
        np.testing.assert_allclose(got["inspected"]["gnorms"][0], norm,
                                   rtol=1e-6)


def test_launcher_rank_trains_on_a_model_mesh(both):
    _, _, port = both
    first = [h["loss"] for h in port[0]["launcher"]]
    assert len(first) == 2 and all(np.isfinite(first))
    for res in port[1:]:
        assert [h["loss"] for h in res["launcher"]] == first


def test_coded_composed_alike_inputs_4x2_against_reference(both):
    """F6 on 4 pods: the coded composed aggregator's error from the exact
    mean no larger than the reference's in every bucket, every rank
    holding the same bits."""
    _, out, port = both
    pods, d = ALIKE
    results = [res["alike"] for res in port]
    alike_against_reference(results, out, pods, d)
    for res in results[1:]:
        for k, v in res["grads"].items():
            assert np.array_equal(v, results[0]["grads"][k]), k
