"""The port's GradientAggregator on one rank (its reductions are held to
the reference on gloo ranks in test_torch_reducers.py and
test_torch_train_step.py): error feedback against the reference's
``codec.ef_quantize``, the chunk-axis rotation of sharded leaves, and the
configuration checks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec

from repro_torch.core import AggregatorConfig, GradientAggregator, Group
from repro_torch.core.fusion import chunk_axis as _chunk_axis


def _agg(**cfg):
    return GradientAggregator(AggregatorConfig(**cfg), ("data",),
                              {"data": Group()})


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal((6, 5))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32))}


@pytest.mark.parametrize("name", ["int8", "fp8_e4m3", "bf16"])
def test_error_feedback_matches_reference(name):
    agg = _agg(codec=name, error_feedback=True)
    grads = _grads()
    res = agg.init_residuals(grads)
    assert len(res) == 1 and float(res[0].abs().sum()) == 0.0
    out, new_res = agg(grads, residuals=res)
    flat = np.concatenate([grads["a"].numpy().ravel(), grads["b"].numpy()])
    q, r = jcodec.ef_quantize(name, jnp.asarray(flat),
                              jnp.zeros_like(jnp.asarray(flat)))
    got = np.concatenate([out["a"].numpy().ravel(), out["b"].numpy()])
    assert np.array_equal(got, np.asarray(q))
    assert np.array_equal(new_res[0].numpy(), np.asarray(r))


def test_sharded_leaf_rotates_to_an_unsharded_dim():
    agg = _agg(codec="int8")
    g = {"embed": torch.arange(12, dtype=torch.float32).reshape(4, 3)}
    out = agg(g, groups={"embed": ("model", None)})
    assert _chunk_axis(("model", None), 2) == 1
    assert out["embed"].shape == (4, 3)
    bucket = agg.last_schedule.buckets[0]
    assert bucket.size == 12 and agg.last_schedule.n_buckets == 1


def test_mean_scalar_on_one_rank():
    agg = _agg()
    x = torch.tensor([1.5, -2.0])
    assert torch.equal(agg.mean_scalar(x), x)


def test_config_checks():
    with pytest.raises(ValueError, match="requires a wire codec"):
        _agg(error_feedback=True)
    with pytest.raises(ValueError, match="no process group"):
        GradientAggregator(AggregatorConfig(), ("data",), {})
    assert AggregatorConfig(codec="int8").resolve_fused_hops()
    assert not AggregatorConfig().resolve_fused_hops()
