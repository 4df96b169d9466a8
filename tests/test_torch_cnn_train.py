"""The CNN train step on 4 gloo ranks against the reference's.

ResNet-50 and MobileNet-v1 at full width, image 32, global batch 8 (2
per rank), float32, from the reference's ``PRNGKey(0)`` parameters and
the same numpy batches, 2 steps under ``rhd_rsa`` and under
``ps_gather`` with fused hops (its terminal sum on K4's plain version).
One JAX subprocess per model writes the initial parameters first; the
ranks, started with them, train while they compile and run their steps.

The port runs ``make_train_step`` with ``optim.sgd(0.05, momentum=0)``
and a clip that never clips (``max_norm`` 1e30: the scale is exactly
1), which is ``p - 0.05 g``; the reference runs
``benchmarks/tf_cnn_analogue.py``'s ``local_step`` (``value_and_grad``
of ``cnn_loss`` → ``GradientAggregator`` → ``p - 0.05 g``) in a JAX
subprocess with 4 host devices.

* Losses within rtol 1e-4.  After 2 steps, each leaf's update
  ``p - p_init`` within a relative L2 distance of the reference's of
  2e-3 (MobileNet-v1; measured 5.3e-4) and 5e-2 (ResNet-50; measured
  2.0e-2).  Updates are not held elementwise: a ReLU input within ~1e-6
  of zero can take opposite signs under the two frameworks' f32 rounding
  (tests/test_torch_cnn.py measures one on ResNet-50), which moves the
  gradient of every leaf upstream of it, and ResNet-50's second step,
  at a loss of 14.6 (SGD at 0.05 on a network without running
  normalisation), amplifies the first step's differences.
* Every rank holds the same bits after each run.
* 21 buckets per ResNet-50 step and 5 per MobileNet-v1 step.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.convert import params_from_numpy
from repro_torch.core import AggregatorConfig, Group, dist
from repro_torch.models import CnnSpec, build_cnn, cnn
from repro_torch.optim import sgd
from repro_torch.train import TrainStepConfig, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("mobilenet", "resnet50")
STRATEGIES = ("rhd_rsa", "ps_gather")
BUCKETS = {"resnet50": 21, "mobilenet": 5}
UPDATE_RTOL = {"mobilenet": 2e-3, "resnet50": 5e-2}
WORLD, IMAGE, BATCH, STEPS = 4, 32, 8, 2


def _batches():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((STEPS, BATCH, IMAGE, IMAGE, 3))
            .astype(np.float32),
            rng.integers(0, 1000, (STEPS, BATCH)).astype(np.int32))


_JAX_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
from devflags import force_host_devices
force_host_devices(4)
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import AggregatorConfig, GradientAggregator
from repro.core.compat import make_mesh, shard_map
from repro.models import cnn

out_dir, name = sys.argv[2], sys.argv[3]
data = np.load(f"{out_dir}/batches.npz")
mesh = make_mesh((4,), ("data",))
init_fn = cnn.resnet50_params if name == "resnet50" else cnn.mobilenet_params
init = init_fn(jax.random.PRNGKey(0))
np.savez(f"{out_dir}/init_{name}.npz", **{
    f"init|{name}|{i}": np.asarray(leaf)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(init))})
open(f"{out_dir}/init_{name}.done", "w").close()
res = {}
fwd = cnn.resnet50_forward if name == "resnet50" else cnn.mobilenet_forward
spec = cnn.CnnSpec(name, image_size=data["images"].shape[2], dtype="float32")
# placed as the step returns them, so the step compiles once
params = jax.device_put(init, NamedSharding(mesh, P()))
for strategy in ("rhd_rsa", "ps_gather"):
    agg = GradientAggregator(AggregatorConfig(
        strategy=strategy, fused_hops=strategy == "ps_gather" or None),
        ("data",))

    # benchmarks/tf_cnn_analogue.py's local_step
    def local_step(p, batch):
        loss, grads = jax.value_and_grad(
            lambda q: cnn.cnn_loss(fwd, q, batch, spec)[0])(p)
        grads = agg(grads)
        p = jax.tree_util.tree_map(lambda a, g: a - 0.05 * g, p, grads)
        return p, jax.lax.pmean(loss, "data")

    bspec = {"images": P("data", None, None, None), "labels": P("data")}
    step = jax.jit(shard_map(local_step, mesh, in_specs=(P(), bspec),
                             out_specs=(P(), P()), axis_names={"data"},
                             check_vma=False))
    p, losses = params, []
    for s in range(data["images"].shape[0]):
        p, loss = step(p, {"images": data["images"][s],
                           "labels": data["labels"][s]})
        losses.append(float(loss))
    res[f"losses|{name}|{strategy}"] = np.asarray(losses)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(p)):
        res[f"final|{name}|{strategy}|{i}"] = np.asarray(leaf)
np.savez(f"{out_dir}/out_{name}.npz", **res)
print("JAX CNN TRAIN DONE")
"""


def _run_both(d, rdv):
    """One JAX subprocess per model and the ranks, started together; the
    ranks train once both subprocesses have written the initial
    parameters, while those compile and run their steps."""
    images, labels = _batches()
    np.savez(d / "batches.npz", images=images, labels=labels)
    script = d / "ref.py"
    script.write_text(_JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["REPRO_TEST_DEVICES"] = "4"
    env["JAX_PLATFORMS"] = "cpu"
    procs = {}
    try:
        for name in MODELS:
            with open(d / f"stderr_{name}.txt", "w") as err:
                procs[name] = subprocess.Popen(
                    [sys.executable, str(script),
                     os.path.join(ROOT, "tests"), str(d), name],
                    stdout=subprocess.PIPE, stderr=err, text=True, env=env)
        port = dist.run_ranks(_rank_train, WORLD, (str(d),),
                              rendezvous_dir=str(rdv), threads=1,
                              timeout_s=600)
        ref = {}
        for name, proc in procs.items():
            rest, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, \
                (d / f"stderr_{name}.txt").read_text()[-4000:]
            assert "JAX CNN TRAIN DONE" in rest
            ref.update(np.load(d / f"init_{name}.npz"))
            ref.update(np.load(d / f"out_{name}.npz"))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return ref, port


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return _run_both(tmp_path_factory.mktemp("jaxcnn"),
                     tmp_path_factory.mktemp("rdv"))


@pytest.fixture(scope="module")
def reference(both):
    return both[0]


def _await_inits(d, names, timeout_s=300):
    """The reference's initial parameters, once its subprocesses in
    ``d`` have written them."""
    deadline = time.monotonic() + timeout_s
    out = {}
    for name in names:
        while not os.path.exists(os.path.join(d, f"init_{name}.done")):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no initial parameters of {name}")
            time.sleep(0.1)
        out.update(np.load(os.path.join(d, f"init_{name}.npz")))
    return out


def _rank_train(rank, world, d):
    torch.set_num_threads(1)
    inits = _await_inits(d, MODELS)
    images, labels = _batches()
    res = {}
    for name in MODELS:
        like = cnn.CNNS[name][0](torch.Generator().manual_seed(0))
        n = len(tree.leaves(like))
        init = [inits[f"init|{name}|{i}"] for i in range(n)]
        api = build_cnn(CnnSpec(name, image_size=IMAGE, dtype="float32"))
        for strategy in STRATEGIES:
            params = params_from_numpy(tree.unflatten(like, init))
            params = tree.tree_map(
                lambda t: torch.nn.Parameter(t), params)
            opt = sgd(0.05, momentum=0.0)
            cfg = TrainStepConfig(aggregator=AggregatorConfig(
                strategy=strategy,
                fused_hops=True if strategy == "ps_gather" else None),
                clip_norm=1e30)
            step, extras = make_train_step(api, opt, cfg,
                                           groups={"data": Group()},
                                           device="cpu")
            state, losses = opt.init(params), []
            for s in range(STEPS):
                params, state, metrics = step(params, state, {
                    "images": torch.from_numpy(images[s]),
                    "labels": torch.from_numpy(labels[s]).long()})
                losses.append(float(metrics["loss"]))
            res[(name, strategy)] = {
                "losses": losses,
                "n_buckets": extras["aggregator"].last_schedule.n_buckets,
                "params": [p.detach().numpy().copy()
                           for p in tree.leaves(params)]}
    return res


@pytest.fixture(scope="module")
def port(both):
    return both[1]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", MODELS)
def test_cnn_steps_match_reference(reference, port, name, strategy):
    got = port[0][(name, strategy)]
    assert got["n_buckets"] == BUCKETS[name]
    np.testing.assert_allclose(got["losses"],
                               reference[f"losses|{name}|{strategy}"],
                               rtol=1e-4)
    for i, p in enumerate(got["params"]):
        init = reference[f"init|{name}|{i}"]
        want = reference[f"final|{name}|{strategy}|{i}"] - init
        gap = float(np.linalg.norm((p - init) - want))
        assert gap <= UPDATE_RTOL[name] * float(np.linalg.norm(want)), \
            (i, gap, float(np.linalg.norm(want)))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", MODELS)
def test_cnn_replicas_are_bit_identical(port, name, strategy):
    first = port[0][(name, strategy)]
    for r in port[1:]:
        assert r[(name, strategy)]["losses"] == first["losses"]
        for a, b in zip(r[(name, strategy)]["params"], first["params"]):
            assert np.array_equal(a, b)
