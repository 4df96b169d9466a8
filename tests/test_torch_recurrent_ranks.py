"""The Mamba2 hybrid and the xLSTM LM on gloo ranks against the
reference (4 gloo ranks spawned once, with file rendezvous, and a JAX
subprocess per arch with 4 host devices running while they run).

The reduced float32 zamba2-1.2b (2 Mamba2 layers, the shared attention
block applied twice) and xlstm-350m (an mLSTM and an sLSTM layer), each
from the reference's initial weights: 3 AdamW steps and 3 SGD steps on
data 2 × model 2 (``launch.mesh.make_groups``), the Mamba2 and xLSTM
projections sharded over the model axis by the reference's rules
(``z_proj``/``xbc_proj``/``up_proj``/``w_in`` by columns,
``out_proj``/``down_proj`` by rows, the conv weights by channels), the
gather boundary at every step, uncoded
``rhd_rsa`` over the data axis.  Losses and the parameters joined from
the model ranks' shards are held to the reference's full-manual
``make_train_step`` on the same mesh and batches, and the two data
replicas to each other bit for bit.  Under SGD the parameters are held
at ``test_torch_train_step.py``'s tolerance (at most 1e-4 of the
elements off by more than 1e-6 + 1e-4·|w|).  AdamW's first steps move an
element by ``±lr`` whatever its gradient's size, so an element whose
gradient is near zero takes the sign of its rounding: the losses at rtol
1e-5, every element within ``2·lr·steps``, and at most 5e-4 of the
elements off by more than 1e-6 + 1e-4·|w| (1.4e-4 and 2.2e-4 measured;
the dense models' 1e-4 holds for SGD).
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import convert, tree
from repro_torch.configs import get_spec
from repro_torch.core import AggregatorConfig, dist
from repro_torch.launch.mesh import make_groups
from repro_torch.models import build_model
from repro_torch.models.common import ParamTree
from repro_torch.optim import adamw, sgd
from repro_torch.train import TrainStepConfig, make_train_step

from test_torch_train_step import _check_uncoded, _nest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
STEPS = 3
LR = 1e-3
ARCHS = ("zamba2-1.2b", "xlstm-350m")
OPTS = {"adamw": LR, "sgd": 0.1}           # optimizer -> learning rate
B, SEQ = 4, 16


def _spec(arch):
    return dataclasses.replace(get_spec(arch).reduced(), dtype="float32")


def _batches():
    rng = np.random.default_rng(23)
    toks = rng.integers(0, 512, (STEPS, B, SEQ + 1)).astype(np.int32)
    return toks[:, :, :-1], toks[:, :, 1:]


def _train(arch, opt_name, init_flat):
    groups = make_groups(1, 2, 2)
    del groups["pod"]
    opt = {"adamw": adamw, "sgd": sgd}[opt_name](OPTS[opt_name])
    step, extras = make_train_step(
        build_model(_spec(arch)), opt, TrainStepConfig(
            aggregator=AggregatorConfig(strategy="rhd_rsa",
                                        fusion_threshold_mb=0.25)),
        groups=groups, device="cpu")
    g = extras["model_group"]
    params = ParamTree(convert.shard_from_numpy(
        _nest(init_flat), extras["mspecs"], g.rank, g.size)).tree()
    state = opt.init(params)
    tokens, labels = _batches()
    losses = []
    for i in range(STEPS):
        params, state, m = step(params, state, {
            "tokens": torch.from_numpy(tokens[i]),
            "labels": torch.from_numpy(labels[i])})
        losses.append(float(m["loss"]))
    return {"losses": losses,
            "render": extras["aggregator"].last_schedule.render(),
            "shards": {"/".join(p): x.detach().numpy().copy()
                       for p, x in tree.leaves_with_path(params)},
            "mspecs": {"/".join(p): s for p, s in
                       tree.leaves_with_path(extras["mspecs"])}}


def _await_inits(d, timeout_s=300):
    """The reference's initial parameters of every arch, once its
    subprocesses in ``d`` have written them."""
    deadline = time.monotonic() + timeout_s
    out = {}
    for arch in ARCHS:
        while not os.path.exists(os.path.join(d, f"init_{arch}.done")):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no initial parameters of {arch}")
            time.sleep(0.1)
        out[arch] = dict(np.load(os.path.join(d, f"init_{arch}.npz")))
    return out


def _rank_cases(rank, world, d):
    torch.set_num_threads(1)
    inits = _await_inits(d)
    return {(arch, opt): _train(arch, opt, inits[arch]) for arch in ARCHS
            for opt in OPTS}


_JAX_SCRIPT = r"""
import dataclasses, sys
sys.path.insert(0, sys.argv[1])
from devflags import force_host_devices
force_host_devices(4)
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_spec
from repro.core import AggregatorConfig
from repro.core.compat import make_mesh
from repro.models import build_model
from repro.optim import adamw, sgd
from repro.serve.step import sanitize_pspec
from repro.train import TrainStepConfig, make_train_step

out_dir, archs = sys.argv[2], sys.argv[3:]
opts = {"adamw": (adamw, 1e-3), "sgd": (sgd, 0.1)}
key = lambda path: "/".join(k.key for k in path)


def put(tree, specs):
    # placed as the step returns it, so the step compiles once
    return jax.device_put(tree, jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, sanitize_pspec(s, mesh)), specs,
        is_leaf=lambda x: isinstance(x, P)))


models, inits = {}, {}
for arch in archs:
    spec = dataclasses.replace(get_spec(arch).reduced(), dtype="float32")
    models[arch] = model = build_model(spec)
    inits[arch] = init = model.init(jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(init)[0]
    np.savez(f"{out_dir}/init_{arch}.npz",
             **{key(p): np.asarray(v) for p, v in flat})
for arch in archs:
    open(f"{out_dir}/init_{arch}.done", "w").close()
data = np.load(f"{out_dir}/batches.npz")
tokens, labels = data["tokens"], data["labels"]
mesh = make_mesh((2, 2), ("data", "model"))
for arch in archs:
    model, init = models[arch], inits[arch]
    out = {}
    for name, (make, lr) in opts.items():
        opt = make(lr)
        cfg = TrainStepConfig(aggregator=AggregatorConfig(
            strategy="rhd_rsa", fusion_threshold_mb=0.25),
            dp_axes=("data",))
        step, sh = make_train_step(model, opt, mesh, cfg,
                                   {"tokens": tokens[0],
                                    "labels": labels[0]}, donate=False)
        params, state = put(init, sh["params"]), put(opt.init(init), sh["opt"])
        losses = []
        for i in range(tokens.shape[0]):
            params, state, m = step(params, state, {"tokens": tokens[i],
                                                    "labels": labels[i]})
            losses.append(float(m["loss"]))
        out[f"{name}|losses"] = np.asarray(losses)
        out["render"] = np.asarray(sh["aggregator"].last_schedule.render())
        for p, v in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{name}|{key(p)}"] = np.asarray(v)
    np.savez(f"{out_dir}/out_{arch}.npz", **out)
print("JAX RECURRENT DONE")
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """One JAX subprocess per arch and the ranks, started together; the
    ranks train once both subprocesses have written the initial
    parameters, while those compile and run their steps."""
    d = tmp_path_factory.mktemp("jax_recurrent")
    tokens, labels = _batches()
    np.savez(d / "batches.npz", tokens=tokens, labels=labels)
    script = d / "ref.py"
    script.write_text(_JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["REPRO_TEST_DEVICES"] = str(WORLD)
    env["JAX_PLATFORMS"] = "cpu"
    procs = {}
    try:
        for arch in ARCHS:
            with open(d / f"stderr_{arch}.txt", "w") as err:
                procs[arch] = subprocess.Popen(
                    [sys.executable, str(script),
                     os.path.join(ROOT, "tests"), str(d), arch],
                    stdout=subprocess.PIPE, stderr=err, text=True, env=env)
        port = dist.run_ranks(
            _rank_cases, WORLD, (str(d),),
            rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
            threads=1, timeout_s=300)
        for arch, proc in procs.items():
            rest, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, \
                (d / f"stderr_{arch}.txt").read_text()[-4000:]
            assert "JAX RECURRENT DONE" in rest
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {arch: dict(np.load(d / f"out_{arch}.npz")) for arch in ARCHS}, \
        port


def _joined(port, key):
    """Each data replica's full parameters, joined from its two model
    ranks' shards (rank = data · 2 + model)."""
    out = []
    for first in (0, 2):
        group = [port[first + i][key] for i in range(2)]
        specs = _nest(group[0]["mspecs"])
        joined = convert.join_shards([_nest(g["shards"]) for g in group],
                                     specs)
        out.append({"/".join(p): v for p, v in
                    tree.leaves_with_path(joined)})
    return out


def test_projections_shard_by_the_reference_rules(both):
    _, port = both
    z = port[0][("zamba2-1.2b", "adamw")]["mspecs"]
    assert z["mamba/mixer/z_proj"] == (None, None, "model")
    assert z["mamba/mixer/out_proj"] == (None, "model", None)
    assert z["mamba/mixer/conv_w"] == (None, None, "model")
    assert z["mamba/mixer/dt_proj"] == ()
    assert z["shared/attn/wq"] == (None, "model")
    x = port[0][("xlstm-350m", "adamw")]["mspecs"]
    assert x["mlstm/mixer/up_proj"] == (None, None, "model")
    assert x["slstm/mixer/w_in"] == (None, None, "model")
    assert x["mlstm/mixer/down_proj"] == (None, "model", None)
    assert x["slstm/mixer/r_rec"] == ()


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_steps_match_reference(both, arch, opt):
    ref, port = both
    out = ref[arch]
    got = port[0][(arch, opt)]
    assert got["render"] == str(out["render"])
    assert "ag@model" in got["render"]
    np.testing.assert_allclose(got["losses"], out[f"{opt}|losses"],
                               rtol=1e-5)
    for params in _joined(port, (arch, opt)):
        if opt == "sgd":
            _check_uncoded({"losses": got["losses"], "params": params},
                           out, opt, STEPS)
            continue
        outside = total = 0
        for path, v in params.items():
            want = out[f"{opt}|{path}"]
            diff = np.abs(v - want)
            assert float(diff.max()) <= 2 * LR * STEPS, path
            outside += int(np.sum(diff > 1e-6 + 1e-4 * np.abs(want)))
            total += v.size
        assert outside <= 5e-4 * total, f"{outside} of {total} elements"


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_replicas_agree(both, arch, opt):
    _, port = both
    reps = _joined(port, (arch, opt))
    for k, v in reps[0].items():
        assert np.array_equal(v, reps[1][k]), k
