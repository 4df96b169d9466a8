"""The port's KV-cache prefill and decode against the reference's, on the
CPU (host only; ~25 s).

The same numpy parameters (the reference's initial weights, carried over
by ``convert.params_from_numpy``) and token ids from a numpy seed go
through ``repro.models.transformer`` and ``repro_torch.models.
transformer``:

* the four dense specs, ``reduced()`` in float32: the prefill's last
  logits and cache, then 4 teacher-forced ``decode_step`` logits and the
  final cache, at ``tests/test_torch_model.py``'s forward tolerance
  (rtol 1e-4 / atol 1e-5);
* reduced gemma with ``sliding_window=8``: the ring buffer, prompt 16
  and 8 decode steps (the reference's ``test_decode_parity.py`` case);
* reduced gemma at head_dim 256 with a 96-token prompt, above
  ``attn_full_seq_max`` 64: the prefill takes the flash path, whose
  plain version K7 replaces on the card;
* the reference's own property on the port in its default bfloat16:
  decode after prefill equals the full forward's last logits within a
  relative 0.05, for each of the four specs and for the rest of the
  family (granite-moe and deepseek-v2-lite at the no-drop
  ``capacity_factor`` 8.0, phi-3-vision after its image patches) and
  the recurrent and encoder-decoder families (zamba2-1.2b, xlstm-350m,
  whisper-tiny after its audio frames), as the reference's
  ``test_decode_parity.py`` holds them.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.models import build_model as jbuild_model

from repro_torch.configs import get_spec
from repro_torch.convert import params_from_numpy
from repro_torch.data.synthetic import extra_inputs
from repro_torch.models import (build_model, encdec, hybrid, ssm_lm,
                                transformer)

DENSE = ("smollm-360m", "granite-3-2b", "deepseek-7b", "gemma-7b")
FAMILY = ("granite-moe-1b-a400m", "deepseek-v2-lite-16b", "phi-3-vision-4.2b")
RECURRENT = ("zamba2-1.2b", "xlstm-350m", "whisper-tiny")
RTOL, ATOL = 1e-4, 1e-5

# label -> (arch, spec overrides, batch, prompt, decode steps, max_seq)
CASES = {
    **{arch: (arch, {}, 2, 8, 4, 16) for arch in DENSE},
    "gemma-7b-window8": ("gemma-7b", {"sliding_window": 8}, 1, 16, 8, 24),
    "gemma-7b-dh256-flash": ("gemma-7b", {"head_dim": 256}, 1, 96, 4, 100),
}


def _specs(arch, dtype, **over):
    j = dataclasses.replace(jget_spec(arch).reduced(), dtype=dtype, **over)
    t = dataclasses.replace(get_spec(arch).reduced(), dtype=dtype, **over)
    return j, t


def _tokens(spec, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, spec.vocab_size, (b, s)).astype(np.int32)


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case):
    arch, over, b, prompt, steps, max_seq = CASES[case]
    jspec, tspec = _specs(arch, "float32", **over)
    jmodel = jbuild_model(jspec)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    toks = _tokens(jspec, b, prompt + steps)

    jlogits, jcache = jmodel.prefill(jparams, {"tokens": toks[:, :prompt]},
                                     max_seq)
    model = build_model(tspec)
    with torch.inference_mode():
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(toks[:, :prompt])}, max_seq)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=RTOL,
                               atol=ATOL, err_msg="prefill logits")
    for k in ("k", "v"):
        np.testing.assert_allclose(cache["body"][k].numpy(),
                                   _np(jcache["body"][k]), rtol=RTOL,
                                   atol=ATOL, err_msg=f"prefill cache {k}")
    assert int(cache["pos"]) == int(jcache["pos"]) == prompt

    for t in range(prompt, prompt + steps):
        jlogits, jcache = jmodel.decode_step(jparams, jcache,
                                             toks[:, t:t + 1])
        with torch.inference_mode():
            logits, cache = model.decode_step(
                params, cache, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=RTOL,
                                   atol=ATOL, err_msg=f"decode at {t}")
    for k in ("k", "v"):
        np.testing.assert_allclose(cache["body"][k].numpy(),
                                   _np(jcache["body"][k]), rtol=RTOL,
                                   atol=ATOL, err_msg=f"final cache {k}")
    assert int(cache["pos"]) == int(jcache["pos"]) == prompt + steps


def _full_logits(spec, params, toks, extra):
    """The full forward's logits over ``toks``, per family (the
    reference test's dispatch)."""
    if spec.family == "hybrid":
        return hybrid.forward(params, toks, spec)
    if spec.family == "ssm":
        return ssm_lm.forward(params, toks, spec)[0]
    if spec.family == "audio":
        enc = encdec.encode(params, extra["frames"], spec)
        return encdec.decoder_forward(params, toks, enc, spec)
    return transformer.forward(params, toks, spec,
                               patches=extra.get("patches"))


@pytest.mark.parametrize("arch", DENSE + FAMILY + RECURRENT)
def test_decode_matches_forward_bf16(arch):
    """The reference's ``test_decode_matches_forward`` on the port, in
    the specs' own bfloat16: prefill 8 (after the VLM's patches, beside
    the audio frames), decode 4, against the full forward's last
    position (relative error under 0.05); experts at the no-drop
    capacity factor 8.0."""
    over = {"capacity_factor": 8.0} if get_spec(arch).num_experts else {}
    _, tspec = _specs(arch, "bfloat16", **over)
    model = build_model(tspec)
    params = model.init(torch.Generator().manual_seed(0), "cpu").tree()
    toks = torch.from_numpy(_tokens(tspec, 2, 12).astype(np.int64))
    extra = extra_inputs(tspec, 2)
    n_img = extra["patches"].shape[1] if "patches" in extra else 0
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": toks[:, :8], **extra},
                                 12 + n_img)
        for t in range(8, 12):
            got, cache = model.decode_step(params, cache, toks[:, t:t + 1])
        want = _full_logits(tspec, params, toks, extra)[:, -1]
    want, got = want.float().numpy(), got.float().numpy()
    err = np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-9)
    assert err < 0.05, f"{arch}: rel err {err}"
