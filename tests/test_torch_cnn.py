"""The port's ResNet-50 and MobileNet-v1 against the reference's, on the CPU.

Full width (1000 classes), image 32, batch 2, from the reference's
``resnet50_params`` / ``mobilenet_params(PRNGKey(0))`` carried into the
port by ``convert.py``; images and labels made with numpy.

* The trees: the same leaf paths in the same order (lists in index
  order), the same fusion buckets (21 and 5 at 4 MiB), the same
  ``param_groups`` tags and the same ``plan()`` JSON and fingerprints
  under each strategy of the CNN step, ``ps_gather`` with fused hops.
* ``conv`` and the stem's max-pool against ``lax.conv_general_dilated``
  and ``lax.reduce_window`` with ``"SAME"`` padding, which is asymmetric
  where the stride is 2 — forward and gradients, f32 at rtol/atol 1e-5.
* Logits and loss: f32 at rtol 1e-4 / atol 1e-5; bf16 at the
  reference's bf16 tolerance, 3e-2.
* Gradients of every leaf: in float64 on both sides at rtol 1e-6 / atol
  1e-8, and in f32 for MobileNet-v1 at rtol 1e-4 / atol 1e-5.  In f32,
  ResNet-50's gradients are a comparison of rounding luck at a ReLU: on
  these inputs one pre-activation of stage 2 lies 5e-7 from zero, and
  oneDNN's and XLA's f32 rounding give it opposite signs, which moves
  every gradient upstream by up to 0.5% of its leaf's largest (the f64
  gradient sides with XLA by chance).  float64 holds the function and
  its gradient without that flip.  In bf16 many such flips occur on both
  sides, so bf16 gradients are held by their accuracy: the port's
  distance to the float64 gradient (global relative L2) is at most 1.25
  times the reference's own.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_plan as jbuild_plan
from repro.core import schedule as jschedule
from repro.models import cnn as jcnn
from repro.models import param_groups as jparam_groups

from repro_torch import tree
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import fusion, schedule
from repro_torch.data import SyntheticImages
from repro_torch.models import CnnSpec, build_cnn, cnn, param_groups
from repro_torch.models.common import ParamTree

MODELS = ("resnet50", "mobilenet")
BUCKETS = {"resnet50": 21, "mobilenet": 5}
_JAX = {"resnet50": (jcnn.resnet50_params, jcnn.resnet50_forward),
        "mobilenet": (jcnn.mobilenet_params, jcnn.mobilenet_forward)}
IMAGE, BATCH = 32, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This file's work on one thread: beside five busy processes the
    float64 gradients took over 480 s on 8 OpenMP threads and ~41 s on
    one (~12 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _ref_numpy(model):
    return jax.tree_util.tree_map(np.asarray,
                                  _JAX[model][0](jax.random.PRNGKey(0)))


def _names(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


@functools.lru_cache(maxsize=None)
def _batch():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
            rng.integers(0, 1000, (BATCH,)).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _reference(model, dtype):
    """(logits, loss, grads as a leaf list) of the reference, float64
    under ``jax.enable_x64``; jitted (eager, each of the ~1,000 ops of
    forward and backward is a program of its own)."""
    init, forward = _JAX[model]
    images, labels = _batch()
    cast = np.float64 if dtype == "float64" else np.float32
    spec = jcnn.CnnSpec(model, image_size=IMAGE, dtype=dtype)

    def loss_fn(p):
        logits = forward(p, jnp.asarray(images.astype(cast)), spec)
        loss = jcnn.cnn_loss(lambda *_: logits, p, {
            "images": None, "labels": jnp.asarray(labels)}, spec)[0]
        return loss, logits

    with jax.enable_x64(dtype == "float64"):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a.astype(cast)),
                                        _ref_numpy(model))
        (loss, logits), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        return (np.asarray(logits, np.float64), float(loss),
                [np.asarray(g, np.float64)
                 for g in jax.tree_util.tree_leaves(grads)])


@functools.lru_cache(maxsize=None)
def _port(model, dtype):
    images, labels = _batch()
    params = params_from_numpy(_ref_numpy(model))
    if dtype == "float64":
        params = tree.tree_map(lambda t: t.double(), params)
    params = tree.tree_map(lambda t: t.requires_grad_(True), params)
    api = build_cnn(CnnSpec(model, image_size=IMAGE, dtype=dtype))
    logits = cnn.CNNS[model][1](params, torch.from_numpy(images), api.spec)
    loss, _ = api.loss(params, {"images": torch.from_numpy(images),
                                "labels": torch.from_numpy(labels)})
    loss.backward()
    return (logits.detach().double().numpy(), float(loss.detach()),
            [p.grad.double().numpy() for p in tree.leaves(params)])


# ---------------------------------------------------------------------------
# trees, buckets and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_trees_match_reference(model):
    """Leaf paths in the reference's order; ``convert.py`` carries the
    reference's tree both ways unchanged; the port's own init has the
    same paths, shapes and f32 dtype."""
    ref = _ref_numpy(model)
    jflat = jax.tree_util.tree_flatten_with_path(ref)[0]
    want = [_names(path) for path, _ in jflat]
    params = params_from_numpy(ref)
    assert [path for path, _ in tree.leaves_with_path(params)] == want
    back = tree.leaves(params_to_numpy(params))
    assert all(np.array_equal(a, b) for (_, a), b in zip(jflat, back))
    own = cnn.CNNS[model][0](torch.Generator().manual_seed(0))
    got = tree.leaves_with_path(own)
    assert [path for path, _ in got] == want
    assert [tuple(t.shape) for _, t in got] == [a.shape for _, a in jflat]
    assert all(t.dtype == torch.float32 for _, t in got)


@pytest.mark.parametrize("model", MODELS)
def test_param_tree_module_keeps_lists(model):
    params = params_from_numpy(_ref_numpy(model))
    module = ParamTree(params)
    out = module.tree()
    key = "stages" if model == "resnet50" else "blocks"
    assert isinstance(out[key], list)
    assert [path for path, _ in tree.leaves_with_path(out)] == \
        [path for path, _ in tree.leaves_with_path(params)]
    assert len(list(module.parameters())) == len(tree.leaves(params))
    assert all(isinstance(p, torch.nn.Parameter) for p in tree.leaves(out))


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("model", MODELS)
def test_fusion_buckets_match_reference(model, grouped):
    ref = _ref_numpy(model)
    params = params_from_numpy(ref)
    jplan = jbuild_plan(ref, 4 << 20,
                        groups=jparam_groups(ref) if grouped else None)
    plan = fusion.build_plan(params, 4 << 20,
                             groups=param_groups(params) if grouped
                             else None)
    assert len(plan.buckets) == BUCKETS[model]
    assert [(b.leaf_indices, b.size) for b in plan.buckets] == \
        [(b.leaf_indices, b.size) for b in jplan.buckets]


@pytest.mark.parametrize("model", MODELS)
def test_param_groups_match_reference(model):
    """The LM's rules name ``w1``/``w2``; on 4-D conv weights both sides
    give every leaf the replicated tag ``()``."""
    ref = _ref_numpy(model)
    got = tree.leaves(param_groups(params_from_numpy(ref)))
    assert got == jax.tree_util.tree_leaves(
        jparam_groups(ref), is_leaf=lambda x: isinstance(x, tuple))
    assert set(got) == {()}


@pytest.mark.parametrize("strategy", ["psum", "ring_rsa", "rhd_rsa",
                                      "ps_gather"])
@pytest.mark.parametrize("model", MODELS)
def test_plan_json_and_fingerprint_match_reference(model, strategy):
    ref = jax.eval_shape(_JAX[model][0], jax.random.PRNGKey(0))
    params = tree.tree_map(lambda s: torch.empty(s.shape), ref)
    kw = dict(axis_names=("data",), axis_sizes=(4,), strategy=strategy,
              threshold_bytes=4 << 20,
              fused_hops=True if strategy == "ps_gather" else None)
    want = jschedule.plan(ref, groups=jparam_groups(ref), **kw)
    got = schedule.plan(params, groups=param_groups(params), **kw)
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    assert got.fingerprint() == want.fingerprint()
    assert got.n_buckets == BUCKETS[model]
    if strategy == "ps_gather":
        assert all(st.fused_hop for b in got.buckets for st in b.stages)


# ---------------------------------------------------------------------------
# "SAME" padding and pooling
# ---------------------------------------------------------------------------

def test_same_pads_are_tf_same():
    assert cnn.same_pads(224, 7, 2) == (2, 3)      # the stem
    assert cnn.same_pads(112, 3, 2) == (0, 1)      # the max-pool
    assert cnn.same_pads(56, 3, 2) == (0, 1)
    assert cnn.same_pads(7, 3, 2) == (1, 1)
    assert cnn.same_pads(14, 1, 2) == (0, 0)
    assert cnn.same_pads(9, 3, 1) == (1, 1)


def _vjp_check(jfn, tfn, args, seed):
    """Forward and gradients of ``jfn``/``tfn`` at ``args`` (numpy)."""
    out, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    g = np.random.default_rng(seed).standard_normal(out.shape) \
        .astype(np.float32)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    tout = tfn(*targs)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    tout.backward(torch.from_numpy(g))
    for jg, ta in zip(vjp(jnp.asarray(g)), targs):
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [9, 10])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k,depthwise", [(1, False), (3, False), (7, False),
                                         (3, True)])
def test_conv_matches_lax_same(k, depthwise, stride, size):
    rng = np.random.default_rng(k * 100 + stride * 10 + size)
    cin = 6
    cout = 1 if depthwise else 5
    x = rng.standard_normal((2, size, size + 1, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cout if depthwise else cin,
                              cin if depthwise else cout)) / k) \
        .astype(np.float32)
    groups = cin if depthwise else 1
    _vjp_check(lambda a, b: jcnn.conv(a, b, stride=stride, groups=groups),
               lambda a, b: cnn.conv(a, b, stride=stride, groups=groups),
               (x, w), seed=size)


@pytest.mark.parametrize("size", [9, 10, 16])
def test_max_pool_matches_reduce_window(size):
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)) \
        .astype(np.float32)
    _vjp_check(lambda a: jax.lax.reduce_window(
        a, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME"),
        cnn.max_pool_same, (x,), seed=size)


# ---------------------------------------------------------------------------
# the models: logits, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", (1e-4, 1e-5)),
                                       ("bfloat16", (3e-2, 3e-2))])
@pytest.mark.parametrize("model", MODELS)
def test_logits_and_loss_match_reference(model, dtype, tol):
    rtol, atol = tol
    logits, loss, _ = _port(model, dtype)
    want_logits, want_loss, _ = _reference(model, dtype)
    assert logits.shape == (BATCH, 1000)
    np.testing.assert_allclose(logits, want_logits, rtol=rtol, atol=atol)
    np.testing.assert_allclose(loss, want_loss, rtol=rtol, atol=atol)


@pytest.mark.parametrize("model,dtype,tol", [
    ("resnet50", "float64", (1e-6, 1e-8)),
    ("mobilenet", "float64", (1e-6, 1e-8)),
    ("mobilenet", "float32", (1e-4, 1e-5))])
def test_every_gradient_leaf_matches_reference(model, dtype, tol):
    rtol, atol = tol
    _, _, grads = _port(model, dtype)
    _, _, want = _reference(model, dtype)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"leaf {i}")


def _rel_l2(a, b):
    num = sum(float(np.sum((x - y) ** 2)) for x, y in zip(a, b))
    return float(np.sqrt(num / sum(float(np.sum(y ** 2)) for y in b)))


@pytest.mark.parametrize("model", MODELS)
def test_bf16_gradients_are_as_accurate_as_reference(model):
    exact = _reference(model, "float64")[2]
    port = _rel_l2(_port(model, "bfloat16")[2], exact)
    ref = _rel_l2(_reference(model, "bfloat16")[2], exact)
    assert port <= 1.25 * ref, (port, ref)


# ---------------------------------------------------------------------------
# SyntheticImages
# ---------------------------------------------------------------------------

def test_synthetic_images_shapes_types_and_determinism():
    data = SyntheticImages(batch=4, image_size=16, num_classes=10, seed=3)
    a, b, c = data.batch_at(0), data.batch_at(0), data.batch_at(1)
    assert a["images"].shape == (4, 16, 16, 3)
    assert a["images"].dtype == torch.float32
    assert a["labels"].shape == (4,) and a["labels"].dtype == torch.int64
    assert int(a["labels"].min()) >= 0 and int(a["labels"].max()) < 10
    assert torch.equal(a["images"], b["images"])
    assert torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["images"], c["images"])
    other = SyntheticImages(batch=4, image_size=16, num_classes=10, seed=4)
    assert not torch.equal(a["images"], other.batch_at(0)["images"])
    big = SyntheticImages(batch=64, image_size=8).batch_at(0)["images"]
    assert abs(float(big.mean())) < 0.05 and abs(float(big.std()) - 1) < 0.05


def test_build_cnn_rejects_unknown_names():
    with pytest.raises(ValueError, match="resnet50"):
        build_cnn(CnnSpec("vgg16"))
