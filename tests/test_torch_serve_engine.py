"""The port's ``ServeEngine`` (host only; ~15 s).

Restates the reference's ``tests/test_serve_generate.py`` (EOS stop
handling, the random state's discipline, the overflow check) and the
engine cases of ``tests/test_serve_engine_cache.py`` (step reuse across
calls, rebuild on a new shape, no shared default config) for the port,
and refuses a model without a decode step,
on the reduced smollm-360m in its bfloat16.  Then, against the
reference's engine on a one-device mesh with the same numpy parameters
in float32: greedy tokens equal exactly, with and without ``eos_id``;
the overflow error's text is the reference's; and under sampling the
token frequencies at fixed logits follow the softmax (a chi-square
bound).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.core.compat import make_mesh
from repro.models import build_model as jbuild_model
from repro.serve import ServeEngine as JServeEngine
from repro.serve.engine import ServeConfig as JServeConfig

from repro_torch.configs import get_spec
from repro_torch.convert import params_from_numpy
from repro_torch.models import CnnSpec, build_cnn, build_model
from repro_torch.serve import ServeConfig, ServeEngine


@pytest.fixture(scope="module")
def setup():
    spec = get_spec("smollm-360m").reduced()
    model = build_model(spec)
    params = model.init(torch.Generator().manual_seed(0), "cpu").tree()
    return spec, model, params


def _toks(spec, b=2, s=8, offset=0, step=7, base=3):
    return ((torch.arange(b * s, dtype=torch.int64) + offset) * step + base
            ).reshape(b, s) % spec.vocab_size


def _engine(setup, **cfg_kw):
    spec, model, params = setup
    return ServeEngine(model, params, None, ServeConfig(**cfg_kw),
                       device="cpu"), spec


# --- the reference's test_serve_generate.py --------------------------------

def test_eos_stop_matches_unstopped_prefix(setup):
    eng_ref, spec = _engine(setup, max_new_tokens=8, max_seq=32, eos_id=-1)
    batch = {"tokens": _toks(spec)}
    ref = eng_ref.generate(batch)
    eos_id = int(ref[0, 3])
    eng, _ = _engine(setup, max_new_tokens=8, max_seq=32, eos_id=eos_id)
    out = eng.generate(batch)
    assert out.shape == ref.shape
    for r in range(ref.shape[0]):
        hits = np.nonzero(ref[r] == eos_id)[0]
        if hits.size == 0:
            np.testing.assert_array_equal(out[r], ref[r])
            continue
        stop = int(hits[0])
        np.testing.assert_array_equal(out[r, :stop + 1], ref[r, :stop + 1])
        assert (out[r, stop + 1:] == eos_id).all(), out[r]


def test_eos_all_finished_exits_early_keeps_cached_steps(setup):
    eng_ref, spec = _engine(setup, max_new_tokens=6, max_seq=32, eos_id=-1)
    batch = {"tokens": _toks(spec, b=1).repeat(2, 1)}
    ref = eng_ref.generate(batch)
    eos_id = int(ref[0, 0])
    assert (ref[:, 0] == eos_id).all()
    eng, _ = _engine(setup, max_new_tokens=6, max_seq=32, eos_id=eos_id)
    calls = []
    out = eng.generate(batch)
    decode1 = eng._decode
    assert (out == eos_id).all(), out
    assert out.shape == ref.shape
    # no decode step ran, and a second call reuses both built steps
    eng._decode = lambda *a: calls.append(a) or decode1(*a)
    wrapped = eng._decode
    eng.generate(batch)
    assert eng._decode is wrapped and not calls


def test_rng_no_generator_state_used_twice(setup):
    """Every generator ``_sample`` receives is new, seeded from a fresh
    draw of the root, and the root itself is never sampled from."""
    eng, spec = _engine(setup, max_new_tokens=5, max_seq=32, greedy=False,
                        temperature=1.0)
    seen = []
    orig = eng._sample

    def recording(logits, gen):
        seen.append(gen)
        return orig(logits, gen)

    eng._sample = recording
    root = torch.Generator().manual_seed(42)
    eng.generate({"tokens": _toks(spec)}, rng=root)
    # prefill sample + one per decode iteration (the last is unused)
    assert len(seen) == 6
    assert all(g is not root for g in seen)
    assert len({id(g) for g in seen}) == 6
    seeds = [g.initial_seed() for g in seen]
    assert len(set(seeds)) == 6 and root.initial_seed() not in seeds, seeds


def test_sampled_streams_follow_the_generator(setup):
    eng, spec = _engine(setup, max_new_tokens=6, max_seq=32, greedy=False,
                        temperature=2.0)
    batch = {"tokens": _toks(spec)}
    outs = {tuple(eng.generate(batch, rng=torch.Generator().manual_seed(s))
                  .ravel().tolist()) for s in range(4)}
    assert len(outs) > 1, "sampling ignores the generator"
    again = eng.generate(batch, rng=torch.Generator().manual_seed(0))
    first = eng.generate(batch, rng=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again, first)


def test_overflow_raises_actionable_valueerror(setup):
    eng, spec = _engine(setup, max_new_tokens=30, max_seq=32)
    with pytest.raises(ValueError) as ei:
        eng.generate({"tokens": _toks(spec, s=8)})       # 8 + 30 > 32
    msg = str(ei.value)
    assert "max_seq" in msg and "max_new_tokens" in msg
    assert "8" in msg and "30" in msg and "32" in msg
    eng2, _ = _engine(setup, max_new_tokens=24, max_seq=32)
    assert eng2.generate({"tokens": _toks(spec, s=8)}).shape == (2, 24)


# --- the engine cases of the reference's test_serve_engine_cache.py ---------

@pytest.mark.parametrize("change", ["same_shape", "new_prompt_len"])
def test_steps_reused_or_rebuilt(setup, change):
    """Same batch shape: both built steps are reused; another prompt
    length rebuilds the prefill (the length is in its key)."""
    eng, spec = _engine(setup, max_new_tokens=4, max_seq=32)
    out1 = eng.generate({"tokens": _toks(spec, b=1, step=1, base=0)})
    prefill1, decode1 = eng._prefill, eng._decode
    assert prefill1 is not None and decode1 is not None
    s = 8 if change == "same_shape" else 16
    out2 = eng.generate({"tokens": _toks(spec, b=1, s=s, offset=3, step=1,
                                         base=0)})
    assert (eng._prefill is prefill1) == (change == "same_shape")
    assert eng._decode is decode1
    assert out1.shape == out2.shape == (1, 4)


def test_model_without_decode_is_refused():
    """A model whose ``ModelApi`` says it has no decode step (the CNNs)
    is refused before anything is built."""
    eng = ServeEngine(build_cnn(CnnSpec("resnet50")), None, device="cpu")
    with pytest.raises(ValueError, match="no decode step"):
        eng.generate({"tokens": torch.zeros((1, 4), dtype=torch.int64)})
    assert eng._prefill is None and eng._decode is None


def test_default_config_not_shared():
    e1 = ServeEngine(model=None, params=None, device="cpu")
    e2 = ServeEngine(model=None, params=None, device="cpu")
    assert e1.cfg is not e2.cfg
    e1.cfg.max_new_tokens = 99
    assert e2.cfg.max_new_tokens == ServeConfig().max_new_tokens


# --- against the reference's engine ----------------------------------------

@pytest.fixture(scope="module")
def both_f32():
    jspec = dataclasses.replace(jget_spec("smollm-360m").reduced(),
                                dtype="float32")
    tspec = dataclasses.replace(get_spec("smollm-360m").reduced(),
                                dtype="float32")
    jmodel = jbuild_model(jspec)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    mesh = make_mesh((1,), ("data",))
    toks = np.random.default_rng(3).integers(
        0, jspec.vocab_size, (2, 8)).astype(np.int32)

    def engines(**cfg):
        return (JServeEngine(jmodel, jparams, mesh, (), JServeConfig(**cfg)),
                ServeEngine(build_model(tspec), params, None,
                            ServeConfig(**cfg), device="cpu"))

    return engines, toks


@pytest.mark.parametrize("eos", [False, True])
def test_greedy_tokens_equal_reference(both_f32, eos):
    engines, toks = both_f32
    jeng, teng = engines(max_new_tokens=10, max_seq=32)
    want = np.asarray(jeng.generate({"tokens": toks}))
    if eos:
        eos_id = int(want[1, 4])
        jeng, teng = engines(max_new_tokens=10, max_seq=32, eos_id=eos_id)
        want = np.asarray(jeng.generate({"tokens": toks}))
        assert (want == eos_id).any()
    got = teng.generate({"tokens": torch.from_numpy(toks)})
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_overflow_text_equals_reference(both_f32):
    engines, toks = both_f32
    jeng, teng = engines(max_new_tokens=30, max_seq=32)
    with pytest.raises(ValueError) as jerr:
        jeng.generate({"tokens": toks})
    with pytest.raises(ValueError) as terr:
        teng.generate({"tokens": torch.from_numpy(toks)})
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_sampling_frequencies_follow_softmax(temperature):
    """80,000 Gumbel-max draws at 8 fixed logits: Pearson's chi-square
    against softmax(logits / T) stays under 40.52, the 1 - 1e-6 quantile
    of chi-square with 7 degrees of freedom."""
    eng = ServeEngine(None, None, cfg=ServeConfig(greedy=False,
                                                  temperature=temperature),
                      device="cpu")
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, -3.0])
    n = 80_000
    draws = eng._sample(logits.expand(n, 8).to(torch.bfloat16),
                        torch.Generator().manual_seed(7))
    counts = np.bincount(draws.numpy(), minlength=8)
    p = torch.softmax(logits.to(torch.bfloat16).float() / temperature,
                      -1).numpy()
    chi2 = float(np.sum((counts - n * p) ** 2 / (n * p)))
    assert chi2 < 40.52, (chi2, counts, n * p)
