"""The port's checkpoints (host only; ~15 s, 2 gloo ranks once).

* The reference's three cases (``tests/test_checkpoint.py``), restated
  on torch tensors.
* One file format: a port ``save`` restores through
  ``repro.checkpoint.restore`` and a reference ``save`` through the
  port's, for a tree with a bfloat16 leaf, an int32 scalar and the
  port optimizers' Python ``int`` count.
* ``Trainer`` with ``ckpt_every=2`` on 4 steps of the reduced smollm-360m
  writes steps 2 and 4, and step 4 restores bit for bit; on a 1 × 2
  model axis over gloo the file holds the full tree (parameters and
  AdamW moments gathered), written by rank 0 alone, equal to what
  ``Trainer.full_state`` gathers.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt

from repro_torch import checkpoint, tree
from repro_torch.core import dist
from repro_torch.launch import train as launch_train


def test_roundtrip(tmp_path):
    t = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                    "b": torch.ones((3,), dtype=torch.bfloat16)},
         "step": torch.tensor(7, dtype=torch.int32)}
    checkpoint.save(str(tmp_path), 7, t)
    like = tree.tree_map(torch.zeros_like, t)
    out = checkpoint.restore(str(tmp_path), 7, like)
    for a, b in zip(tree.leaves(t), tree.leaves(out)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_latest_step(tmp_path):
    assert checkpoint.latest_step(str(tmp_path)) is None
    checkpoint.save(str(tmp_path), 3, {"x": torch.zeros(2)})
    checkpoint.save(str(tmp_path), 11, {"x": torch.zeros(2)})
    assert checkpoint.latest_step(str(tmp_path)) == 11


def test_shape_mismatch_raises(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"x": torch.zeros(2)})
    with pytest.raises(ValueError):
        checkpoint.restore(str(tmp_path), 1, {"x": torch.zeros(3)})


def _mixed():
    """One tree in both packages' forms: f32 and bf16 leaves, a list, an
    int32 scalar, and the optimizer count (an int in the port, a 0-d
    int32 array in the reference)."""
    w = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    b = (np.arange(5, dtype=np.float32) - 2.5).astype(ml_dtypes.bfloat16)
    port = {"params": {"w": torch.from_numpy(w.copy()),
                       "b": torch.from_numpy(b.astype(np.float32)).to(
                           torch.bfloat16),
                       "layers": [torch.ones(2), torch.full((2,), 3.0)]},
            "step": torch.tensor(9, dtype=torch.int32),
            "opt": {"count": 5}}
    ref = {"params": {"w": jnp.asarray(w), "b": jnp.asarray(b),
                      "layers": [jnp.ones(2), jnp.full((2,), 3.0)]},
           "step": jnp.asarray(9, jnp.int32),
           "opt": {"count": jnp.asarray(5, jnp.int32)}}
    return port, ref


def _zeros_port(t):
    return tree.tree_map(lambda x: 0 if isinstance(x, int)
                         else torch.zeros_like(x), t)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_restores_across_packages(tmp_path, writer):
    port, ref = _mixed()
    if writer == "port":
        checkpoint.save(str(tmp_path), 4, port)
        out = jckpt.restore(str(tmp_path), 4,
                            jax.tree_util.tree_map(jnp.zeros_like, ref))
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                jax.tree_util.tree_leaves(out)):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32))
    else:
        jckpt.save(str(tmp_path), 4, ref)
        out = checkpoint.restore(str(tmp_path), 4, _zeros_port(port))
        assert out["opt"]["count"] == 5 and isinstance(out["opt"]["count"],
                                                       int)
        for a, b in zip(tree.leaves(port), tree.leaves(out)):
            if isinstance(a, int):
                continue
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
    assert checkpoint.latest_step(str(tmp_path)) == \
        jckpt.latest_step(str(tmp_path)) == 4


def _args(ckpt_dir, mesh=None):
    argv = ["--arch", "smollm-360m", "--device", "cpu", "--steps", "4",
            "--batch", "4", "--seq", "16", "--dtype", "float32",
            "--log-every", "4", "--ckpt-every", "2", "--ckpt-dir", ckpt_dir]
    return launch_train.parser().parse_args(
        argv + (["--mesh", mesh] if mesh else []))


def _numpy(t):
    return tree.tree_map(lambda x: x if isinstance(x, int)
                         else x.detach().numpy().copy(), t)


def test_trainer_writes_every_two_steps(tmp_path):
    trainer = launch_train.build_trainer(_args(str(tmp_path)), verbose=False)
    module, opt_state, _ = trainer.run()
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["ckpt_00000002.npz", "ckpt_00000004.npz"]
    state = {"params": module.tree(), "opt": opt_state}
    out = checkpoint.restore(str(tmp_path), 4, _zeros_port(state))
    assert out["opt"]["count"] == 4
    for a, b in zip(tree.leaves(state), tree.leaves(out)):
        if not isinstance(a, int):
            assert torch.equal(a.detach(), b)


def _model_axis_rank(rank, world, ckpt_dir):
    torch.set_num_threads(1)
    trainer = launch_train.build_trainer(_args(ckpt_dir, "1x2"),
                                         verbose=False)
    module, opt_state, _ = trainer.run()
    shards = _numpy(module.tree())
    full = _numpy(trainer.full_state(module.tree(), opt_state))
    return {"shards": shards, "full": full}


def test_model_axis_writes_the_full_tree(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    port = dist.run_ranks(_model_axis_rank, 2, (ckpt_dir,),
                          rendezvous_dir=str(tmp_path), threads=1,
                          timeout_s=300)
    full = port[0]["full"]
    for path, leaf in tree.leaves_with_path(port[1]["full"]):
        a = dict(tree.leaves_with_path(full))[path]
        np.testing.assert_array_equal(a, leaf, err_msg="/".join(path))
    # the ranks held shards; the file holds the gathered tree
    assert port[0]["shards"]["embed"].shape[0] * 2 == \
        full["params"]["embed"].shape[0]
    like = tree.tree_map(lambda x: 0 if isinstance(x, int)
                         else torch.zeros(x.shape), full)
    for step in (2, 4):
        out = checkpoint.restore(ckpt_dir, step, like)
        assert out["opt"]["count"] == step
    for path, leaf in tree.leaves_with_path(out):
        want = dict(tree.leaves_with_path(full))[path]
        if isinstance(leaf, int):
            assert leaf == want
        else:
            np.testing.assert_array_equal(leaf.numpy(), want,
                                          err_msg="/".join(path))
