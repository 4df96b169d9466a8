"""The whole slice at p=2 against the reference, plus the port's package
rules.

Two gloo ranks run the port's ``make_train_step`` (value-and-grad ->
aggregator -> clip -> K5 AdamW) and a JAX subprocess with 2 host devices
runs the reference's ``make_train_step`` on a ``("data",)`` mesh, from
the same initial parameters and the same numpy batches, for 3 steps of
the reduced float32 smollm-360m:

* ``codec="none"``: losses within 1e-5 relative; parameters within
  rtol 1e-4 / atol 1e-6 on all but 1e-4 of the elements, and every
  element within the 2·lr per step that AdamW can move it.  The
  exceptions are gradients near ``eps``: there ``m/(sqrt(v)+eps)``
  turns a last-bit difference in the summation order into a visible
  difference of the step (measured: 5 of 65536 elements of
  ``body/attn/wk``, 3.1e-5 apart);
* ``codec="int8"`` (fused hops): losses within 1e-3 relative — a one-ulp
  gradient difference may flip one int8 quantum;
* one uncoded step at seq 128, above the reduced spec's
  ``attn_full_seq_max`` of 64, where both sides take their flash path:
  held as the uncoded steps are.

Also: importing every ``repro_torch`` module (and chip_smoke.py) leaves
``jax`` and ``repro`` out of ``sys.modules``, no source imports them,
and an entry point with no device argument raises where CUDA is absent.
"""
import ast
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
from repro_torch.core import AggregatorConfig, Group
from repro_torch.core import dist
from repro_torch.models import build_model
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim import adamw
from repro_torch.train import TrainStepConfig, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODECS = ("none", "int8")
STEPS = 3
LR = 1e-3


def _batches(steps=STEPS, seq=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (steps, 4, seq + 1)).astype(np.int32)
    return toks[:, :, :-1], toks[:, :, 1:]


def _long_batches():
    return _batches(steps=1, seq=128, seed=1)


def _spec():
    return dataclasses.replace(get_spec("smollm-360m").reduced(),
                               dtype="float32")


def _agg(codec):
    return AggregatorConfig(strategy="rhd_rsa", codec=codec,
                            fusion_threshold_mb=0.25)


_JAX_SCRIPT = r"""
import dataclasses, sys
sys.path.insert(0, sys.argv[1])
from devflags import force_host_devices
force_host_devices(2)
import jax, numpy as np
from repro.configs import get_spec
from repro.core import AggregatorConfig, compat
from repro.models import build_model
from repro.optim import adamw
from repro.train import TrainStepConfig, make_train_step

out_dir = sys.argv[2]
spec = dataclasses.replace(get_spec("smollm-360m").reduced(), dtype="float32")
model = build_model(spec)
init = model.init(jax.random.PRNGKey(0))
flat = jax.tree_util.tree_flatten_with_path(init)[0]
key = lambda path: "/".join(k.key for k in path)
np.savez(f"{out_dir}/init.npz", **{key(p): np.asarray(v) for p, v in flat})
data = np.load(f"{out_dir}/batches.npz")
mesh = compat.make_mesh((2,), ("data",))
res = {}
for run, codec, sfx in (("none", "none", ""), ("int8", "int8", ""),
                        ("long", "none", "_long")):
    opt = adamw(float(sys.argv[3]))
    cfg = TrainStepConfig(aggregator=AggregatorConfig(
        strategy="rhd_rsa", codec=codec, fusion_threshold_mb=0.25))
    tokens, labels = data["tokens" + sfx], data["labels" + sfx]
    example = {"tokens": tokens[0], "labels": labels[0]}
    step, _ = make_train_step(model, opt, mesh, cfg, example, donate=False)
    params, state, losses = init, opt.init(init), []
    for i in range(tokens.shape[0]):
        params, state, m = step(params, state, {
            "tokens": tokens[i], "labels": labels[i]})
        losses.append(float(m["loss"]))
    res[f"{run}|losses"] = np.asarray(losses)
    for p, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        res[f"{run}|{key(p)}"] = np.asarray(v)
np.savez(f"{out_dir}/out.npz", **res)
print("JAX TRAIN DONE")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("jaxtrain")
    tokens, labels = _batches()
    tokens_long, labels_long = _long_batches()
    np.savez(d / "batches.npz", tokens=tokens, labels=labels,
             tokens_long=tokens_long, labels_long=labels_long)
    script = d / "ref.py"
    script.write_text(_JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["REPRO_TEST_DEVICES"] = "2"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(script), os.path.join(ROOT, "tests"), str(d),
         str(LR)], capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "JAX TRAIN DONE" in proc.stdout
    init = dict(np.load(d / "init.npz"))
    out = dict(np.load(d / "out.npz"))
    return init, out


def _nest(flat: dict) -> dict:
    root: dict = {}
    for path, v in flat.items():
        node = root
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return root


def _rank_train(rank, world, init_flat):
    torch.set_num_threads(1)
    spec = _spec()
    res = {}
    for run, codec in (("none", "none"), ("int8", "int8"),
                       ("long", "none")):
        tokens, labels = _long_batches() if run == "long" else _batches()
        module = TransformerLM(spec, params_from_numpy(_nest(init_flat)))
        opt = adamw(LR)
        step, extras = make_train_step(
            build_model(spec), opt, TrainStepConfig(aggregator=_agg(codec)),
            groups={"data": Group()}, device="cpu")
        params = module.tree()
        state = opt.init(params)
        losses = []
        for i in range(tokens.shape[0]):
            batch = {"tokens": torch.from_numpy(tokens[i]),
                     "labels": torch.from_numpy(labels[i])}
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
        res[run] = {"losses": losses,
                      "n_buckets": extras["aggregator"].last_schedule
                      .n_buckets,
                      "params": {"/".join(path): p.detach().numpy().copy()
                                 for path, p in
                                 tree.leaves_with_path(params)}}
    return res


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    init, _ = reference
    return dist.run_ranks(_rank_train, 2, (init,),
                          rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
                          threads=1, timeout_s=300)


def _check_uncoded(got, out, run, steps):
    np.testing.assert_allclose(got["losses"], out[f"{run}|losses"],
                               rtol=1e-5)
    outside = total = 0
    for path, v in got["params"].items():
        want = out[f"{run}|{path}"]
        diff = np.abs(v - want)
        outside += int(np.sum(diff > 1e-6 + 1e-4 * np.abs(want)))
        total += v.size
        assert float(diff.max()) <= 2 * LR * steps, path
    assert outside <= 1e-4 * total, f"{outside} of {total} elements"


def test_uncoded_steps_match_reference(reference, port):
    _check_uncoded(port[0]["none"], reference[1], "none", STEPS)


def test_long_context_step_matches_reference(reference, port):
    """One step at seq 128: both sides' flash attention inside the
    data-parallel step."""
    _check_uncoded(port[0]["long"], reference[1], "long", 1)


def test_int8_fused_hop_steps_match_reference(reference, port):
    _, out = reference
    got = port[0]["int8"]
    assert got["n_buckets"] == 9
    np.testing.assert_allclose(got["losses"], out["int8|losses"], rtol=1e-3)


@pytest.mark.parametrize("codec", CODECS)
def test_ranks_hold_identical_parameters(port, codec):
    a, b = port[0][codec], port[1][codec]
    assert a["losses"] == b["losses"]
    for path, v in a["params"].items():
        assert np.array_equal(v, b["params"][path]), path


@pytest.mark.parametrize("world", [1, 2])
def test_launcher_trains_on_the_host(world):
    from repro_torch.launch import train
    args = ["--arch", "smollm-360m", "--steps", "2", "--batch", "4",
            "--seq", "16", "--world", str(world), "--device", "cpu",
            "--codec", "int8", "--log-every", "1"]
    assert train.main(args) == 0


def _port_modules():
    pkg = os.path.join(ROOT, "src", "repro_torch")
    mods = []
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      os.path.join(ROOT, "src"))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_importing_the_port_loads_no_jax_or_reference():
    code = ("import importlib, sys\n"
            f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, {ROOT!r}]\n"
            f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout


def test_no_source_imports_jax_or_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src",
                                                  "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            mod = ast.parse(f.read())
        for node in ast.walk(mod):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), \
                    f"{path} imports {n}"


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.train import Trainer, TrainerConfig
    spec = _spec()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(build_model(spec), adamw(LR), TrainStepConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(build_model(spec), adamw(LR), lambda s: {}, TrainerConfig())
