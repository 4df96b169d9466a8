"""How far rounding moves xlstm-350m's logits at its published depth, in
the port and in the reference, on the CPU (one process; 30–52 s alone,
44–52 test-seconds inside the six-worker Tier-1 run, where the two cases
took 162 and 718 s on 8 threads with the reference run eagerly).

xlstm-350m's layout (an sLSTM every 8th block) at 256 wide, float32,
with the reference's weights (``PRNGKey(7)``, through
``convert.params_from_numpy``) and the same numpy tokens.  With random
weights the xLSTM amplifies rounding over its depth, and so does the
reference: its own chunked and sequential forms lie ~0.4 apart at 24
layers and ~1e-6 at 2.  The reference's ``prefill`` and ``decode_step``
run jitted, one compile per spec and shape (eager, each call of a layer
traced and compiled its scans anew); the port runs on one thread.

Its own file so that ``pytest --dist loadfile`` can give it a worker of
its own.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.models import build_model as jbuild_model

from repro_torch.configs import get_spec
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model

ARCH = "xlstm-350m"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(got, want):
    """The max difference relative to the largest magnitude of ``want``
    (chip_smoke.py's measure)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-9))


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's per-token loops are thousands of small ops: on one
    thread, since OpenMP workers spin-waiting beside other busy
    processes made them ~100× slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jitted(spec):
    """The reference's ``(prefill, decode_step)`` for ``spec``, jitted."""
    m = jbuild_model(spec)
    return (jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, 0)),
            jax.jit(m.decode_step))


@pytest.mark.parametrize("layers", [2, 24])
def test_depth_amplifies_rounding_alike(layers):
    """xlstm-350m's layout (an sLSTM every 8th block) at 256 wide, with
    the reference's weights: how far rounding moves the last logits, in
    the reference and in the port, at 2 layers and at the published 24.
    At 24 layers the reference's own chunked (64) and sequential forms
    lie more than 1e-2 apart in float32 and its bf16 decode more than
    0.05 from its bf16 forward; at 2 layers its forms agree within 1e-4
    and its bf16 decode within 0.05.  The port's chunked and sequential
    forms, and its sequential form against the reference's, lie no
    farther apart than 4 times the reference's own forms (or 1e-5);
    decode = forward holds in float32 within 0.05 over 32 + 8 tokens;
    and the bf16 decode lies no farther from the float32 forward than
    1.5 times the bf16 forward (chip_smoke.py's ``DECODE_FAITH``), in
    both.  Prints the readings."""
    over = dict(num_layers=layers, d_model=256, vocab_size=4096,
                dtype="float32")
    jspec = dataclasses.replace(jget_spec(ARCH), **over)
    tspec = dataclasses.replace(get_spec(ARCH), **over)
    jp = jbuild_model(jspec).init(jax.random.PRNGKey(7))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    toks = np.random.default_rng(8).integers(
        0, jspec.vocab_size, (2, 264)).astype(np.int32)

    def ref(spec, tokens, prompt):
        jprefill, jdecode = _jitted(spec)
        jl, jc = jprefill(jp, tokens[:, :prompt])
        for i in range(prompt, tokens.shape[1]):
            jl, jc = jdecode(jp, jc, tokens[:, i:i + 1])
        return np.asarray(jl, np.float32)

    def port(spec, tokens, prompt):
        tm = build_model(spec)
        with torch.inference_mode():
            tl, tc = tm.prefill(tp, {"tokens": _t(tokens[:, :prompt]).long()})
            for i in range(prompt, tokens.shape[1]):
                tl, tc = tm.decode_step(tp, tc,
                                        _t(tokens[:, i:i + 1]).long())
        return tl.float().numpy()

    def alt(**o):
        return (dataclasses.replace(jspec, **o),
                dataclasses.replace(tspec, **o))

    # The last logits of the forward over the tokens (prefill), or of
    # decode after a prefill of the first ``prompt`` of them.
    f32, chk, bf16 = (jspec, tspec), alt(mlstm_chunk=64), \
        alt(dtype="bfloat16")
    runs = {"seq": (f32, toks[:, :256], 256),
            "chunked": (chk, toks[:, :256], 256),
            "dec32": (f32, toks[:, :40], 32),
            "fwd32": (f32, toks[:, :40], 40),
            "want32": (f32, toks, 264), "dec16": (bf16, toks, 256),
            "fwd16": (bf16, toks, 264)}
    got = {k: (ref(s[0], t, n), port(s[1], t, n))
           for k, (s, t, n) in runs.items()}
    seq, chunked, dec32, fwd32, want32, dec16, fwd16 = (
        got[k] for k in runs)
    r = {"chunked vs sequential, float32 (ref, port)":
         [_rel(chunked[i], seq[i]) for i in (0, 1)],
         "port against ref, sequential": _rel(seq[1], seq[0]),
         "decode vs forward, float32, 32 + 8":
         [_rel(dec32[i], fwd32[i]) for i in (0, 1)],
         "decode vs forward, bf16, 256 + 8":
         [_rel(dec16[i], fwd16[i]) for i in (0, 1)],
         "bf16 decode, bf16 forward, from the float32 forward (ref)":
         [_rel(dec16[0], want32[0]), _rel(fwd16[0], want32[0])],
         "bf16 decode, bf16 forward, from the float32 forward (port)":
         [_rel(dec16[1], want32[1]), _rel(fwd16[1], want32[1])]}
    print(f"\n{layers} layers: {r}")
    ref_gap = max(r["chunked vs sequential, float32 (ref, port)"][0], 1e-5)
    if layers == 24:
        assert ref_gap > 1e-2
        assert r["decode vs forward, bf16, 256 + 8"][0] > 0.05
    else:
        assert ref_gap < 1e-4
        assert r["decode vs forward, bf16, 256 + 8"][0] < 0.05
    assert r["chunked vs sequential, float32 (ref, port)"][1] <= 4 * ref_gap
    assert r["port against ref, sequential"] <= 4 * ref_gap
    assert max(r["decode vs forward, float32, 32 + 8"]) < 0.05
    for who in ("ref", "port"):
        dec, fwd = r[f"bf16 decode, bf16 forward, from the float32 forward "
                     f"({who})"]
        assert dec <= 1.5 * fwd, who
