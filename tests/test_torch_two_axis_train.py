"""The train step over two dp axes (pod × data) against the reference.

Four gloo ranks laid out 2 pods × 2 by ``launch.mesh.make_groups`` run
the port's ``make_train_step`` with ``dp_axes=("pod", "data")``, and a
JAX subprocess with 4 host devices runs the reference's
``make_train_step`` on ``make_host_mesh(pods=2, data=2, model=1)``, from
the same initial parameters and numpy batches, for 3 steps of the
reduced float32 smollm-360m, at ``test_torch_train_step.py``'s
tolerances:

* ``ring_rsa×rhd_rsa`` uncoded: losses within 1e-5 relative, parameters
  within rtol 1e-4 / atol 1e-6 on all but 1e-4 of the elements and
  every element within 2·lr per step;
* ``ring_rsa×rhd_rsa`` + ``bf16×int8`` (fused hops): losses within 1e-3
  relative;
* each rank's rows of the global batch are at ``pod·d + data``, and
  every rank holds the same parameters.

Also: the launcher trains on ``--mesh 2x2x1`` on the host.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_spec
from repro_torch.convert import params_from_numpy
from repro_torch.core import AggregatorConfig, dist
from repro_torch.launch.mesh import DP_AXES, make_groups
from repro_torch.models import build_model
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim import adamw
from repro_torch.train import TrainStepConfig, make_train_step
from repro_torch.train.step import shard_batch

from test_torch_train_step import _check_uncoded, _nest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PODS, D = 2, 2
STEPS = 3
LR = 1e-3
RUNS = (("composed", "ring_rsa×rhd_rsa", "none"),
        ("coded", "ring_rsa×rhd_rsa", "bf16×int8"))


def _batches():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (STEPS, 2 * PODS * D, 33)).astype(np.int32)
    return toks[:, :, :-1], toks[:, :, 1:]


def _spec():
    return dataclasses.replace(get_spec("smollm-360m").reduced(),
                               dtype="float32")


_JAX_SCRIPT = r"""
import dataclasses, sys
sys.path.insert(0, sys.argv[1])
from devflags import force_host_devices
force_host_devices(4)
import jax, numpy as np
from repro.configs import get_spec
from repro.core import AggregatorConfig
from repro.launch.mesh import dp_axes_of, make_host_mesh
from repro.models import build_model
from repro.optim import adamw
from repro.train import TrainStepConfig, make_train_step

out_dir, lr = sys.argv[2], float(sys.argv[3])
runs = [r.split(":") for r in sys.argv[4].split(",")]
spec = dataclasses.replace(get_spec("smollm-360m").reduced(), dtype="float32")
model = build_model(spec)
init = model.init(jax.random.PRNGKey(0))
flat = jax.tree_util.tree_flatten_with_path(init)[0]
key = lambda path: "/".join(k.key for k in path)
np.savez(f"{out_dir}/init.npz", **{key(p): np.asarray(v) for p, v in flat})
data = np.load(f"{out_dir}/batches.npz")
mesh = make_host_mesh(pods=2, data=2, model=1)
res = {}
for run, strategy, codec in runs:
    opt = adamw(lr)
    cfg = TrainStepConfig(aggregator=AggregatorConfig(
        strategy=strategy, codec=codec, fusion_threshold_mb=0.25),
        dp_axes=dp_axes_of(mesh))
    tokens, labels = data["tokens"], data["labels"]
    step, _ = make_train_step(model, opt, mesh, cfg,
                              {"tokens": tokens[0], "labels": labels[0]},
                              donate=False)
    params, state, losses = init, opt.init(init), []
    for i in range(tokens.shape[0]):
        params, state, m = step(params, state, {
            "tokens": tokens[i], "labels": labels[i]})
        losses.append(float(m["loss"]))
    res[f"{run}|losses"] = np.asarray(losses)
    for p, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        res[f"{run}|{key(p)}"] = np.asarray(v)
np.savez(f"{out_dir}/out.npz", **res)
print("JAX TWO-AXIS TRAIN DONE")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_two_axis_train")
    tokens, labels = _batches()
    np.savez(d / "batches.npz", tokens=tokens, labels=labels)
    script = d / "ref.py"
    script.write_text(_JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["REPRO_TEST_DEVICES"] = "4"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(script), os.path.join(ROOT, "tests"), str(d),
         str(LR), ",".join(":".join(r) for r in RUNS)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "JAX TWO-AXIS TRAIN DONE" in proc.stdout
    return dict(np.load(d / "init.npz")), dict(np.load(d / "out.npz"))


def _rank_train(rank, world, init_flat):
    torch.set_num_threads(1)
    spec = _spec()
    groups = make_groups(PODS, D)
    tokens, labels = _batches()
    res = {"rows": shard_batch({"tokens": torch.from_numpy(tokens[0])},
                               [groups[a] for a in DP_AXES])["tokens"]
           .numpy().copy()}
    for run, strategy, codec in RUNS:
        module = TransformerLM(spec, params_from_numpy(_nest(init_flat)))
        opt = adamw(LR)
        cfg = TrainStepConfig(aggregator=AggregatorConfig(
            strategy=strategy, codec=codec, fusion_threshold_mb=0.25),
            dp_axes=DP_AXES)
        step, extras = make_train_step(build_model(spec), opt, cfg,
                                       groups=groups, device="cpu")
        params = module.tree()
        state = opt.init(params)
        losses = []
        for i in range(STEPS):
            params, state, metrics = step(params, state, {
                "tokens": torch.from_numpy(tokens[i]),
                "labels": torch.from_numpy(labels[i])})
            losses.append(float(metrics["loss"]))
        sched = extras["aggregator"].last_schedule
        res[run] = {"losses": losses, "render": sched.render(),
                    "params": {"/".join(path): p.detach().numpy().copy()
                               for path, p in tree.leaves_with_path(params)}}
    return res


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    init, _ = reference
    return dist.run_ranks(_rank_train, PODS * D, (init,),
                          rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
                          threads=1, timeout_s=300)


def test_composed_steps_match_reference(reference, port):
    assert port[0]["composed"]["render"] == "ring@data×rhd@pod×9"
    _check_uncoded(port[0]["composed"], reference[1], "composed", STEPS)


def test_coded_composed_steps_match_reference(reference, port):
    _, out = reference
    got = port[0]["coded"]
    assert got["render"] == "ring@data:bf16×rhd@pod:int8×9"
    np.testing.assert_allclose(got["losses"], out["coded|losses"], rtol=1e-3)


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_ranks_hold_identical_parameters(port, run):
    first = port[0][run]
    for res in port[1:]:
        assert res[run]["losses"] == first["losses"]
        for path, v in first["params"].items():
            assert np.array_equal(v, res[run]["params"][path]), path


def test_batch_rows_are_pod_major(port):
    tokens, _ = _batches()
    per = tokens.shape[1] // (PODS * D)
    for rank, res in enumerate(port):
        assert np.array_equal(res["rows"],
                              tokens[0][rank * per:(rank + 1) * per])


def test_launcher_trains_on_a_pod_mesh():
    from repro_torch.launch import train
    args = ["--arch", "smollm-360m", "--steps", "2", "--batch", "4",
            "--seq", "16", "--mesh", "2x2x1", "--device", "cpu",
            "--strategy", "ring_rsa×rhd_rsa", "--codec", "bf16×int8",
            "--log-every", "1"]
    assert train.main(args) == 0
    # a --world that disagrees with the mesh (its model axis included)
    with pytest.raises(ValueError, match="has 8 ranks"):
        train.main(["--arch", "smollm-360m", "--mesh", "2x2x2",
                    "--world", "4", "--device", "cpu"])
