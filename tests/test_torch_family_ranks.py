"""The MoE + MLA family on gloo ranks against the reference (4 gloo
ranks spawned once, with file rendezvous, and one JAX subprocess with 4
host devices running while they run).

The reduced float32 deepseek-v2-lite-16b (MLA, a dense prefix layer,
4 routed experts top-2 and 2 shared) with the reference's initial
weights:

* 3 AdamW steps on data 2 × model 2 (``launch.mesh.make_groups``): the
  routed experts sharded over the model axis on their expert dim, MLA's
  projections by columns or rows, the gather boundary at every step,
  uncoded ``rhd_rsa`` over the data axis; losses and the parameters
  joined from the model ranks' shards against the reference's
  full-manual ``make_train_step`` on the same mesh and batches, at
  ``test_torch_train_step.py``'s tolerances;
* greedy serving on two 1 × 2 meshes side by side (ranks 0-1 and 2-3,
  each rank holding its shards): every rank's tokens and last logits
  bit for bit a one-rank engine's on the full weights.
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
from repro_torch.core import AggregatorConfig, dist, manual
from repro_torch.launch.mesh import make_groups
from repro_torch.models import build_model
from repro_torch.models.common import ParamTree
from repro_torch.optim import adamw
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import TrainStepConfig, make_train_step

from test_torch_train_step import _check_uncoded, _nest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
STEPS = 3
LR = 1e-3
ARCH = "deepseek-v2-lite-16b"
B, SEQ = 4, 16
PROMPT, NEW = 8, 6


def _spec():
    return dataclasses.replace(get_spec(ARCH).reduced(), dtype="float32")


def _batches():
    rng = np.random.default_rng(17)
    toks = rng.integers(0, 512, (STEPS, B, SEQ + 1)).astype(np.int32)
    return toks[:, :, :-1], toks[:, :, 1:]


def _groups_1x2(rank):
    """Data groups of one rank each, model groups {0, 1} and {2, 3}
    (every rank creates every subgroup, in one order)."""
    mine = {}
    for ax, lists in (("data", [[r] for r in range(WORLD)]),
                      ("model", [[0, 1], [2, 3]])):
        for members in lists:
            pg = torch.distributed.new_group(members)
            if rank in members:
                mine[ax] = pg
    return {ax: dist.Group(mine[ax], name=ax) for ax in ("data", "model")}


def _train(init_flat):
    groups = make_groups(1, 2, 2)
    del groups["pod"]
    model = build_model(_spec())
    opt = adamw(LR)
    step, extras = make_train_step(
        model, opt, TrainStepConfig(aggregator=AggregatorConfig(
            strategy="rhd_rsa", fusion_threshold_mb=0.25)),
        groups=groups, device="cpu")
    g = extras["model_group"]
    params = ParamTree(convert.shard_from_numpy(
        _nest(init_flat), extras["mspecs"], g.rank, g.size)).tree()
    state = opt.init(params)
    tokens, labels = _batches()
    losses, aux = [], []
    for i in range(STEPS):
        params, state, m = step(params, state, {
            "tokens": torch.from_numpy(tokens[i]),
            "labels": torch.from_numpy(labels[i])})
        losses.append(float(m["loss"]))
        aux.append((float(m["aux"]), float(m["drop"])))
    return {"losses": losses, "aux": aux,
            "render": extras["aggregator"].last_schedule.render(),
            "shards": {"/".join(p): x.detach().numpy().copy()
                       for p, x in tree.leaves_with_path(params)},
            "mspecs": {"/".join(p): s for p, s in
                       tree.leaves_with_path(extras["mspecs"])}}


def _serve(rank, init_flat):
    full = _nest(init_flat)
    toks = torch.from_numpy(_batches()[0][0][:, :PROMPT].copy())
    cfg = ServeConfig(max_new_tokens=NEW, max_seq=PROMPT + NEW + 1)
    model = build_model(_spec())
    groups = _groups_1x2(rank)
    g = groups["model"]
    mspecs = manual.model_shard_specs(convert.params_from_numpy(full),
                                      g.size)
    out, last = {}, {}
    for label, params, grp in (
            ("mesh", convert.shard_from_numpy(full, mspecs, g.rank, g.size),
             groups),
            ("one", convert.params_from_numpy(full), None)):
        eng = ServeEngine(model, params, grp, cfg, device="cpu")
        sample = eng._sample

        def recording(logits, gen, label=label, sample=sample):
            last[label] = logits.numpy().copy()
            return sample(logits, gen)

        eng._sample = recording
        out[label] = eng.generate({"tokens": toks})
    shapes = {"/".join(p): tuple(x.shape) for p, x in tree.leaves_with_path(
        convert.shard_from_numpy(full, mspecs, g.rank, g.size))}
    return {"tokens": out, "last": last, "shard_shapes": shapes}


def _rank_cases(rank, world, init_flat):
    torch.set_num_threads(1)
    return {"train": _train(init_flat), "serve": _serve(rank, init_flat)}


_JAX_SCRIPT = r"""
import dataclasses, sys
sys.path.insert(0, sys.argv[1])
from devflags import force_host_devices
force_host_devices(4)
import jax, numpy as np
from repro.configs import get_spec
from repro.core import AggregatorConfig
from repro.core.compat import make_mesh
from repro.models import build_model
from repro.optim import adamw
from repro.train import TrainStepConfig, make_train_step

out_dir, lr, arch = sys.argv[2], float(sys.argv[3]), sys.argv[4]
spec = dataclasses.replace(get_spec(arch).reduced(), dtype="float32")
model = build_model(spec)
init = model.init(jax.random.PRNGKey(0))
flat = jax.tree_util.tree_flatten_with_path(init)[0]
key = lambda path: "/".join(k.key for k in path)
np.savez(f"{out_dir}/init.npz", **{key(p): np.asarray(v) for p, v in flat})
print("INIT WRITTEN", flush=True)
data = np.load(f"{out_dir}/batches.npz")
tokens, labels = data["tokens"], data["labels"]
mesh = make_mesh((2, 2), ("data", "model"))
opt = adamw(lr)
cfg = TrainStepConfig(aggregator=AggregatorConfig(
    strategy="rhd_rsa", fusion_threshold_mb=0.25), dp_axes=("data",))
step, sh = make_train_step(model, opt, mesh, cfg,
                           {"tokens": tokens[0], "labels": labels[0]},
                           donate=False)
params, state, losses, aux = init, opt.init(init), [], []
for i in range(tokens.shape[0]):
    params, state, m = step(params, state, {"tokens": tokens[i],
                                            "labels": labels[i]})
    losses.append(float(m["loss"]))
    aux.append((float(m["aux"]), float(m["drop"])))
out = {"none|losses": np.asarray(losses), "aux": np.asarray(aux),
       "render": np.asarray(sh["aggregator"].last_schedule.render())}
for p, v in jax.tree_util.tree_flatten_with_path(params)[0]:
    out[f"none|{key(p)}"] = np.asarray(v)
np.savez(f"{out_dir}/out.npz", **out)
print("JAX FAMILY DONE")
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX subprocess, started first; the ranks start once it has
    written the initial parameters, and run while it trains."""
    d = tmp_path_factory.mktemp("jax_family")
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
         str(LR), ARCH],
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
    assert "JAX FAMILY DONE" in rest
    return init, dict(np.load(d / "out.npz")), port


def _joined(port):
    """Each data replica's full parameters, joined from its two model
    ranks' shards (rank = data · 2 + model)."""
    out = []
    for first in (0, 2):
        group = [port[first + i]["train"] for i in range(2)]
        specs = _nest(group[0]["mspecs"])
        joined = convert.join_shards([_nest(g["shards"]) for g in group],
                                     specs)
        out.append({"/".join(p): v for p, v in
                    tree.leaves_with_path(joined)})
    return out


def test_experts_shard_on_their_expert_dim(both):
    _, _, port = both
    got = port[0]["train"]["mspecs"]
    assert got["body/moe/w1"] == (None, "model", None, None)
    assert got["body/moe/shared/w1"] == (None, None, "model")
    assert got["body/attn/wdkv"] == (None, None, "model")
    assert got["prefix/mlp/w2"] == (None, "model", None)
    spec = _spec()
    shapes = port[0]["serve"]["shard_shapes"]
    assert shapes["body/moe/w2"] == (spec.num_layers - 1,
                                     spec.num_experts // 2, spec.moe_d_ff,
                                     spec.d_model)


def test_steps_match_reference(both):
    _, out, port = both
    got = port[0]["train"]
    assert got["render"] == str(out["render"])
    assert "ag@model" in got["render"]
    np.testing.assert_allclose(np.asarray(got["aux"]), out["aux"],
                               rtol=1e-5)
    for params in _joined(port):
        _check_uncoded({"losses": got["losses"], "params": params}, out,
                       "none", STEPS)


def test_replicas_agree(both):
    _, _, port = both
    reps = _joined(port)
    for k, v in reps[0].items():
        assert np.array_equal(v, reps[1][k]), k
    for res in port[1:]:
        assert res["train"]["losses"] == port[0]["train"]["losses"]


def test_serving_on_1x2_equals_one_rank(both):
    _, _, port = both
    for r, res in enumerate(port):
        got = res["serve"]
        assert got["tokens"]["mesh"].shape == (B, NEW)
        assert np.array_equal(got["tokens"]["mesh"], got["tokens"]["one"]), r
        assert np.array_equal(got["last"]["mesh"].view(np.uint32),
                              got["last"]["one"].view(np.uint32)), r
        assert np.array_equal(got["tokens"]["mesh"],
                              port[0]["serve"]["tokens"]["mesh"]), r
