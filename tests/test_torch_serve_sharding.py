"""The port's cache-sharding rules against the reference's (host only;
~5 s).

``serve/sharding.py``'s ``_leaf_spec`` on ``tests/test_serve_sharding.py``'s
shapes (data 16 × model 16), ``cache_pspecs`` over the caches of the
four reduced dense specs on three meshes, and ``serve/step.py``'s
``sanitize_pspec`` and ``strip_axis`` on specs naming axes a mesh may
lack, equal the reference's ``PartitionSpec``s entry for entry.  A port
spec is compared as ``PartitionSpec(*spec)``, which reads a one-axis
tuple as that axis, as the reference's own spec does.  The port's axis
sizes come from the process groups, the reference's from the mesh.
"""
import types

import jax
import pytest

from jax.sharding import PartitionSpec as P

from repro.configs import get_spec as jget_spec
from repro.models import build_model as jbuild_model
from repro.serve.sharding import _leaf_spec as j_leaf_spec
from repro.serve.sharding import cache_pspecs as j_cache_pspecs
from repro.serve.step import sanitize_pspec as j_sanitize_pspec
from repro.serve.step import strip_axis as j_strip_axis

from repro_torch import tree
from repro_torch.configs import get_spec
from repro_torch.models import build_model
from repro_torch.serve.sharding import _leaf_spec, cache_pspecs
from repro_torch.serve.step import sanitize_pspec, strip_axis

DENSE = ("smollm-360m", "granite-3-2b", "deepseek-7b", "gemma-7b")
LEAF_SHAPES = ((28, 128, 32768, 16, 256), (40, 128, 32768, 8, 64),
               (28, 1, 8192, 16, 256), (38, 128, 64, 64, 64), ())
# mesh label -> axis sizes, pod major and model minor
MESHES = {"2x2": {"data": 2, "model": 2}, "4x1": {"data": 4},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
SPECS = ((None, ("pod", "data"), "model", None), (("data",), None, "model"),
         ("model", ("data", "model")), ())
CASES = [("leaf", shape, None) for shape in LEAF_SHAPES] + \
    [("cache", arch, mesh) for arch in DENSE for mesh in MESHES] + \
    [("spec", spec, mesh) for spec in SPECS for mesh in MESHES]


def _groups(sizes):
    return {ax: types.SimpleNamespace(size=n) for ax, n in sizes.items()}


@pytest.mark.parametrize("kind,what,mesh", CASES,
                         ids=[f"{k}-{w}-{m}" for k, w, m in CASES])
def test_specs_equal_reference(kind, what, mesh):
    if kind == "leaf":
        got = _leaf_spec(what, ("data",), 16, 16)
        assert isinstance(got, tuple) and len(got) == len(what)
        assert P(*got) == j_leaf_spec(what, ("data",), 16, 16)
        return
    if kind == "spec":
        mesh_like = types.SimpleNamespace(axis_names=tuple(MESHES[mesh]))
        assert P(*sanitize_pspec(what, MESHES[mesh])) == \
            j_sanitize_pspec(P(*what), mesh_like)
        assert P(*strip_axis(what)) == j_strip_axis(P(*what))
        return
    sizes = MESHES[mesh]
    dp_axes = tuple(ax for ax in ("pod", "data") if ax in sizes)
    jmodel = jbuild_model(jget_spec(what).reduced())
    tpl = jax.eval_shape(lambda: jmodel.init_cache(8, 16))
    want = j_cache_pspecs(tpl, types.SimpleNamespace(shape=sizes), dp_axes)
    got = cache_pspecs(build_model(get_spec(what).reduced()).init_cache(
        8, 16, device="meta"), _groups(sizes), dp_axes)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): spec
            for path, spec in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, P))[0]}
    got = {"/".join(path): P(*spec) for path, spec in
           tree.leaves_with_path(got)}
    assert got == want
    assert any("model" in tuple(s) for s in got.values()) == \
        ("model" in sizes)
