"""Serving on ranks against the reference (~25 s: 4 gloo ranks once, with
file rendezvous, and one JAX subprocess with 4 host devices running
while they run).

The reduced float32 smollm-360m with the reference's initial weights,
4 prompts of 8 tokens from a numpy seed, 8 greedy new tokens:

* on ``--mesh 2x2`` (data 2 × model 2, all four ranks, gloo and
  ``cuda_ipc`` on the host's shared memory) and on ``--mesh 1x2`` (ranks
  0-1 and 2-3, two meshes side by side), every rank's tokens equal the
  reference ``ServeEngine``'s on the same host mesh;
* each rank holds its model shards (the gather boundary rebuilds the
  full weights each step), and the rows its cache holds follow
  ``cache_pspecs`` (model-replicated): on 2 × 2 a data rank's two rows,
  equal to a one-rank engine's cache on those rows; on 1 × 2 all four;
* the launcher's rank entry on ``--mesh 2x2`` at the reduced bf16 spec
  gives every rank the same tokens.
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
from repro_torch.core import dist, manual
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_groups
from repro_torch.models import build_model
from repro_torch.serve import ServeConfig, ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
B, PROMPT, NEW = 4, 8, 8
MAX_SEQ = PROMPT + NEW + 1
# label -> (data, model)
MESHES = {"2x2": (2, 2), "1x2": (1, 2)}


def _spec():
    return dataclasses.replace(get_spec("smollm-360m").reduced(),
                               dtype="float32")


def _tokens():
    return np.random.default_rng(5).integers(0, 512, (B, PROMPT)) \
        .astype(np.int32)


def _nest(flat):
    out = {}
    for key, v in flat.items():
        *head, last = key.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _groups_1x2(rank):
    """Data groups of one rank each and model groups {0, 1}, {2, 3}
    (every rank creates every subgroup, in one order)."""
    mine = {}
    for ax, lists in (("data", [[r] for r in range(WORLD)]),
                      ("model", [[0, 1], [2, 3]])):
        for members in lists:
            pg = torch.distributed.new_group(members)
            if rank in members:
                mine[ax] = pg
    return {ax: dist.Group(mine[ax], name=ax) for ax in ("data", "model")}


def _serve(groups, full, toks):
    spec = _spec()
    model = build_model(spec)
    g = groups["model"]
    mspecs = manual.model_shard_specs(convert.params_from_numpy(full),
                                      g.size)
    params = convert.shard_from_numpy(full, mspecs, g.rank, g.size)
    eng = ServeEngine(model, params, groups,
                      ServeConfig(max_new_tokens=NEW, max_seq=MAX_SEQ),
                      device="cpu")
    out = eng.generate({"tokens": torch.from_numpy(toks)})
    prefill = eng._prefill
    _, cache = prefill(params, {"tokens": torch.from_numpy(toks)})
    return {"tokens": out,
            "shard_shapes": {"/".join(p): tuple(x.shape)
                             for p, x in tree.leaves_with_path(params)},
            "cache_k": cache["body"]["k"].numpy().copy(),
            "cache_specs": {"/".join(p): s for p, s in
                            tree.leaves_with_path(prefill.cache_specs)},
            "rows": (prefill.rows.start, prefill.rows.stop)}


def _rank_cases(rank, world, full, toks):
    torch.set_num_threads(1)
    out = {}
    groups = make_groups(1, 2, 2)
    del groups["pod"]
    out["2x2"] = _serve(groups, full, toks)
    ipc = make_groups(1, 2, 2, transport="cuda_ipc")
    del ipc["pod"]
    out["2x2 cuda_ipc"] = _serve(ipc, full, toks)
    out["1x2"] = _serve(_groups_1x2(rank), full, toks)
    args = launch_serve.parser().parse_args(
        ["--arch", "smollm-360m", "--mesh", "2x2", "--device", "cpu",
         "--batch", "4", "--prompt-len", "8", "--new-tokens", "6"])
    out["launcher"] = launch_serve._rank_main(rank, world, args)[0]
    return out


_JAX_SCRIPT = r"""
import dataclasses, sys
sys.path.insert(0, sys.argv[1])
from devflags import force_host_devices
force_host_devices(4)
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_spec
from repro.models import build_model
from repro.serve import ServeEngine
from repro.serve.engine import ServeConfig

out_dir, new, max_seq = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
spec = dataclasses.replace(get_spec("smollm-360m").reduced(), dtype="float32")
model = build_model(spec)
params = model.init(jax.random.PRNGKey(0))
flat = jax.tree_util.tree_flatten_with_path(params)[0]
np.savez(f"{out_dir}/init.npz",
         **{"/".join(k.key for k in p): np.asarray(v) for p, v in flat})
print("INIT WRITTEN", flush=True)
toks = np.load(f"{out_dir}/tokens.npy")
out = {}
for name, (d, m) in (("2x2", (2, 2)), ("1x2", (1, 2))):
    mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))
    eng = ServeEngine(model, params, mesh, ("data",),
                      ServeConfig(max_new_tokens=new, max_seq=max_seq))
    out[name] = np.asarray(eng.generate({"tokens": toks}))
np.savez(f"{out_dir}/out.npz", **out)
print("JAX SERVE DONE")
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_serve")
    toks = _tokens()
    np.save(d / "tokens.npy", toks)
    script = d / "ref.py"
    script.write_text(_JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["REPRO_TEST_DEVICES"] = str(WORLD)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, str(script), os.path.join(ROOT, "tests"), str(d),
         str(NEW), str(MAX_SEQ)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        for line in proc.stdout:
            if line.startswith("INIT WRITTEN"):
                break
        full = _nest(dict(np.load(d / "init.npz")))
        port = dist.run_ranks(
            _rank_cases, WORLD, (full, toks),
            rendezvous_dir=str(tmp_path_factory.mktemp("rdv")), threads=1,
            timeout_s=300)
        rest, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    assert "JAX SERVE DONE" in rest
    return full, toks, dict(np.load(d / "out.npz")), port


@pytest.mark.parametrize("run", ["2x2", "2x2 cuda_ipc", "1x2"])
def test_tokens_equal_reference(both, run):
    _, _, ref, port = both
    want = ref[run.split()[0]]
    for rank, res in enumerate(port):
        np.testing.assert_array_equal(res[run]["tokens"], want,
                                      err_msg=f"rank {rank}")


@pytest.mark.parametrize("run", ["2x2", "2x2 cuda_ipc", "1x2"])
def test_cache_rows_follow_cache_pspecs(both, run):
    """The cache's batch entry names the data axis on 2 × 2 (two rows a
    data rank, in data-rank order) and nothing on 1 × 2 (all rows); no
    entry names the model axis; each rank's cache equals a one-rank
    engine's on its rows, and each rank holds model shards."""
    full, toks, _, port = both
    d, m = MESHES[run.split()[0]]
    one = build_model(_spec())
    with torch.inference_mode():
        _, cache = one.prefill(convert.params_from_numpy(full),
                               {"tokens": torch.from_numpy(toks)}, MAX_SEQ)
    whole = cache["body"]["k"].numpy()
    for rank, res in enumerate(port):
        r = res[run]
        spec_k = r["cache_specs"]["body/k"]
        assert "model" not in spec_k and r["cache_specs"]["pos"] == ()
        assert spec_k[1] == (("data",) if d > 1 else None)
        data_rank = rank // m if d > 1 else 0
        per = B // d
        assert r["rows"] == (data_rank * per, (data_rank + 1) * per)
        np.testing.assert_allclose(r["cache_k"], whole[:, r["rows"][0]:
                                                       r["rows"][1]],
                                   rtol=1e-5, atol=1e-6)
        assert r["shard_shapes"]["embed"] == (full["embed"].shape[0] // m,
                                              full["embed"].shape[1])


def test_launcher_ranks_agree(both):
    _, _, _, port = both
    outs = [res["launcher"] for res in port]
    assert outs[0].shape == (4, 6)
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
