"""Sequence parallelism and overlap on a model axis against the reference.

One spawn of 4 gloo ranks (file rendezvous) laid out as data 2 × model 2
(``launch.mesh.make_groups``), and one JAX subprocess with 4 host
devices running the reference's ``make_train_step`` on the same mesh
from the same numpy inputs while the ranks run (the ranks start once it
has written the initial parameters).  3 AdamW steps of reduced float32
models, uncoded ``rhd_rsa`` over the data axis, each run's losses and
parameters (joined from the model ranks' shards) held at
``test_torch_train_step.py``'s tolerances:

* ``seq_parallel=True`` (the reference's legacy partial-auto step)
  against the port's full-manual step with its sequence split over the
  model ranks: smollm-360m through ``sdpa_full``, and again with
  ``attn_full_seq_max`` lowered so that the flash path with a query
  offset runs (K7/K8's plain versions on the CPU); deepseek-v2-lite
  (MLA, MoE, a dense prefix layer) at a capacity that drops tokens, with
  ``remat=True``; phi-3-vision (8 image patches and 24 text tokens, so
  the first chunk holds patches and text); smollm on ``cuda_ipc``
  groups (shared memory here);
* phi-3-vision's full-manual step without ``seq_parallel`` leaves more
  than ``_check_uncoded``'s 1e-4 share of elements outside
  1e-6 + 1e-4·|x| of the reference after 3 AdamW steps (262 of
  1,443,072 here; AdamW turns a last-bit difference in a gradient near
  zero into a visible one), so its sequence-parallel run is held to the
  losses and the largest difference as the others are, and to no more
  elements outside than that step has against the same reference;
* ``overlap=True`` on the model axis against the reference's
  overlapped full-manual step, and bit for bit against the port's
  post-backward step; ``seq_parallel`` with ``overlap=True`` bit for
  bit against ``seq_parallel`` alone;
* serving through ``launch/serve.py::build_engine`` on the same mesh: a
  ``seq_parallel`` spec (served outside the tensor-parallel path, as the
  reference serves it, each rank holding the full weights) gives the
  plain spec's greedy tokens.

About 75 s alone on an 8-core host (the JAX subprocess's six
configurations dominate).
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
from repro_torch.core import AggregatorConfig, dist
from repro_torch.launch.mesh import make_groups
from repro_torch.launch.serve import build_engine
from repro_torch.launch.serve import parser as serve_parser
from repro_torch.models import build_model
from repro_torch.models.common import ParamTree
from repro_torch.optim import adamw
from repro_torch.train import TrainStepConfig, make_train_step

from test_torch_train_step import _check_uncoded, _nest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
STEPS = 3
LR = 1e-3
B = 4
SMOLLM, DSV2, PHI3 = "smollm-360m", "deepseek-v2-lite-16b", \
    "phi-3-vision-4.2b"
SP = {"seq_parallel": True}
# name -> (arch, spec overrides, text length)
CONFIGS = {
    "base": (SMOLLM, {}, 32),
    "sp": (SMOLLM, SP, 32),
    "sp_flash": (SMOLLM, {**SP, "attn_full_seq_max": 8}, 32),
    "sp_moe": (DSV2, {**SP, "capacity_factor": 0.5, "remat": True}, 16),
    "vlm": (PHI3, {}, 24),
    "sp_vlm": (PHI3, SP, 24),
}
# port run -> (config, transport, overlap); the reference runs the
# configs in REFERENCE (overlap for "overlap")
RUNS = {
    "manual": ("base", "gloo", False),
    "overlap": ("base", "gloo", True),
    "sp": ("sp", "gloo", False),
    "sp_flash": ("sp_flash", "gloo", False),
    "sp_moe": ("sp_moe", "gloo", False),
    "sp_vlm": ("sp_vlm", "gloo", False),
    "vlm": ("vlm", "gloo", False),
    "sp_ipc": ("sp", "cuda_ipc", False),
    "sp_overlap": ("sp", "gloo", True),
}
REFERENCE = {"overlap": ("base", True), "sp": ("sp", False),
             "sp_flash": ("sp_flash", False), "sp_moe": ("sp_moe", False),
             "sp_vlm": ("sp_vlm", False), "vlm": ("vlm", False)}


def _spec(config):
    arch, over, _ = CONFIGS[config]
    return dataclasses.replace(get_spec(arch).reduced(), dtype="float32",
                               **over)


def _batches(config):
    """``STEPS`` global batches: tokens and labels, and for the VLM
    patches (float32 values of bf16 numbers, as ``extra_inputs``
    gives)."""
    arch, _, seq = CONFIGS[config]
    rng = np.random.default_rng(23)
    toks = rng.integers(0, 512, (STEPS, B, seq + 1)).astype(np.int32)
    out = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
    spec = _spec(config)
    if spec.num_image_tokens:
        p = rng.standard_normal((STEPS, B, spec.num_image_tokens,
                                 spec.d_model)).astype(np.float32)
        out["patches"] = torch.from_numpy(p).to(torch.bfloat16) \
            .to(torch.float32).numpy()
    return out


def _train(run, groups, init_flat):
    config, _, overlap = RUNS[run]
    spec = _spec(config)
    model = build_model(spec)
    opt = adamw(LR)
    step, extras = make_train_step(
        model, opt, TrainStepConfig(aggregator=AggregatorConfig(
            strategy="rhd_rsa", fusion_threshold_mb=0.25, overlap=overlap)),
        groups=groups, device="cpu")
    g = extras["model_group"]
    params = ParamTree(convert.shard_from_numpy(
        _nest(init_flat), extras["mspecs"], g.rank, g.size)).tree()
    state = opt.init(params)
    data = _batches(config)
    losses, drops = [], []
    for i in range(STEPS):
        params, state, m = step(params, state, {
            k: torch.from_numpy(v[i]) for k, v in data.items()})
        losses.append(float(m["loss"]))
        drops.append(float(m["drop"]))
    with torch.no_grad():
        full = extras["gather"](params)
    return {"losses": losses, "drops": drops,
            "render": extras["aggregator"].last_schedule.render(),
            "shards": {"/".join(p): x.detach().numpy().copy()
                       for p, x in tree.leaves_with_path(params)},
            "params": {"/".join(p): x.detach().numpy().copy()
                       for p, x in tree.leaves_with_path(full)}}


def _serve():
    """Greedy tokens of the reduced smollm-360m, plain and
    ``seq_parallel``, from ``build_engine`` on ``--mesh 2x2``."""
    args = serve_parser().parse_args(
        ["--arch", SMOLLM, "--mesh", "2x2", "--device", "cpu", "--batch",
         "4", "--prompt-len", "16", "--new-tokens", "6"])
    out = {}
    for label, over in (("plain", {}), ("sp", SP)):
        spec = dataclasses.replace(get_spec(SMOLLM).reduced(),
                                   dtype="float32", **over)
        engine, batch = build_engine(args, spec=spec)
        out[label] = np.asarray(engine.generate(batch))
    return out


def _rank_cases(rank, world, inits):
    torch.set_num_threads(1)
    groups = {}
    for transport in ("gloo", "cuda_ipc"):
        g = make_groups(1, 2, 2, transport=transport)
        del g["pod"]
        groups[transport] = g
    out = {run: _train(run, groups[transport], inits[CONFIGS[config][0]])
           for run, (config, transport, _) in RUNS.items()}
    out["serve"] = _serve()
    return out


_JAX_SCRIPT = r"""
import dataclasses, json, sys
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

out_dir, lr = sys.argv[2], float(sys.argv[3])
configs = json.loads(sys.argv[4])
reference = json.loads(sys.argv[5])
key = lambda path: "/".join(k.key for k in path)


def spec_of(config):
    arch, over, _ = configs[config]
    return dataclasses.replace(get_spec(arch).reduced(), dtype="float32",
                               **over)


inits = {}
for config, (arch, _, _) in configs.items():
    if arch in inits:
        continue
    init = build_model(spec_of(config)).init(jax.random.PRNGKey(0))
    inits[arch] = init
    flat = jax.tree_util.tree_flatten_with_path(init)[0]
    np.savez(f"{out_dir}/init_{arch}.npz",
             **{key(p): np.asarray(v) for p, v in flat})
print("INIT WRITTEN", flush=True)
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for run, (config, overlap) in reference.items():
    model = build_model(spec_of(config))
    data = dict(np.load(f"{out_dir}/batches_{config}.npz"))
    opt = adamw(lr)
    cfg = TrainStepConfig(aggregator=AggregatorConfig(
        strategy="rhd_rsa", fusion_threshold_mb=0.25, overlap=overlap),
        dp_axes=("data",))
    step, sh = make_train_step(model, opt, mesh, cfg,
                               {k: v[0] for k, v in data.items()},
                               donate=False)
    init = inits[configs[config][0]]
    params, state, losses, drops = init, opt.init(init), [], []
    for i in range(data["tokens"].shape[0]):
        params, state, m = step(params, state,
                                {k: v[i] for k, v in data.items()})
        losses.append(float(m["loss"]))
        drops.append(float(m["drop"]))
    out[f"{run}|losses"] = np.asarray(losses)
    out[f"{run}|drops"] = np.asarray(drops)
    out[f"{run}|render"] = np.asarray(sh["aggregator"].last_schedule.render())
    for p, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[f"{run}|{key(p)}"] = np.asarray(v)
np.savez(f"{out_dir}/out.npz", **out)
print("JAX SEQ-PARALLEL DONE")
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX subprocess, started first; the ranks start once it has
    written the initial parameters, and run while it trains."""
    import json
    d = tmp_path_factory.mktemp("jax_seq_parallel")
    for config in CONFIGS:
        np.savez(d / f"batches_{config}.npz", **_batches(config))
    script = d / "ref.py"
    script.write_text(_JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["REPRO_TEST_DEVICES"] = str(WORLD)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, str(script), os.path.join(ROOT, "tests"), str(d),
         str(LR), json.dumps(CONFIGS), json.dumps(REFERENCE)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        for line in proc.stdout:
            if line.startswith("INIT WRITTEN"):
                break
        inits = {arch: dict(np.load(d / f"init_{arch}.npz"))
                 for arch, _, _ in CONFIGS.values()}
        port = dist.run_ranks(
            _rank_cases, WORLD, (inits,),
            rendezvous_dir=str(tmp_path_factory.mktemp("rdv")), threads=1,
            timeout_s=300)
        rest, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    assert "JAX SEQ-PARALLEL DONE" in rest
    return dict(np.load(d / "out.npz")), port


def _outside(got, out, run):
    """Elements outside ``_check_uncoded``'s 1e-6 + 1e-4·|x|."""
    return sum(int(np.sum(np.abs(v - out[f"{run}|{path}"])
                          > 1e-6 + 1e-4 * np.abs(out[f"{run}|{path}"])))
               for path, v in got["params"].items())


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("run, ref", [
    ("sp", "sp"), ("sp_flash", "sp_flash"), ("sp_moe", "sp_moe"),
    ("sp_ipc", "sp"), ("overlap", "overlap")])
def test_step_matches_reference(both, run, ref):
    out, port = both
    for res in port:
        got = res[run]
        # every model rank joins the same parameters
        for k, v in got["params"].items():
            assert np.array_equal(v, port[0][run]["params"][k]), k
        _check_uncoded(got, out, ref, STEPS)


def test_vlm_step_no_further_from_reference_than_manual(both):
    out, port = both
    for res in port:
        got = res["sp_vlm"]
        for k, v in got["params"].items():
            assert np.array_equal(v, port[0]["sp_vlm"]["params"][k]), k
        np.testing.assert_allclose(got["losses"], out["sp_vlm|losses"],
                                   rtol=1e-5)
        for path, v in got["params"].items():
            diff = np.abs(v - out[f"sp_vlm|{path}"])
            assert float(diff.max()) <= 2 * LR * STEPS, path
        assert _outside(got, out, "sp_vlm") <= \
            _outside(res["vlm"], out, "vlm")


def test_moe_drops_tokens(both):
    """The capacity drops tokens, and the port drops the reference's
    share: the dispatch sees the whole sequence on every model rank."""
    out, port = both
    for res in port:
        drops = res["sp_moe"]["drops"]
        assert all(d > 0 for d in drops), drops
        np.testing.assert_allclose(drops, out["sp_moe|drops"], atol=1e-6)


def test_plans_keep_the_model_bracket(both):
    """The port's sequence-parallel step keeps the bracketed plan of the
    non-SP manual step; the reference's legacy step plans without it."""
    out, port = both
    for res in port:
        assert res["sp"]["render"] == res["manual"]["render"]
        assert "ag@model" in res["sp"]["render"]
    assert "ag@model" not in str(out["sp|render"])


@pytest.mark.parametrize("run, base", [("overlap", "manual"),
                                       ("sp_overlap", "sp")])
def test_overlap_bit_for_bit_post_backward(both, run, base):
    _, port = both
    for res in port:
        assert res[run]["losses"] == res[base]["losses"]
        for k, v in res[run]["shards"].items():
            assert _same_bits(v, res[base]["shards"][k]), k


def test_serving_a_seq_parallel_spec_gives_the_plain_tokens(both):
    _, port = both
    for res in port:
        got = res["serve"]
        assert got["sp"].shape == got["plain"].shape
        assert np.array_equal(got["sp"], got["plain"])
        assert np.array_equal(got["sp"], port[0]["serve"]["sp"])
