"""The port's ``BatchServer`` against the JAX package's on the CPU.

Both servers get the same float32 parameters (JAX ``registry.init``
carried through numpy) and the same prompts, and must give equal
greedy tokens, ``decode_steps`` and ``tokens_out``: the logits agree to
about 1e-6 (``tests/test_torch_models.py``), far inside the gap between
the top two logits of these draws, so every argmax is the same.  The
EOS regression of ``tests/test_runtime.py`` runs on both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.serve.loop import BatchServer as JaxServer
from repro_torch import configs as tconfigs
from repro_torch.models import registry as treg
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import build_decode_step, build_prefill_step
from repro_torch.serve.loop import BatchServer


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen3_4b"), remat=False,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke("qwen3_4b"), remat=False,
                               dtype=torch.float32)
    jparams = jreg.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab, (2, 12)).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, prompts


def _both(pair, prompts=None, **kw):
    jcfg, jparams, tcfg, tparams, default = pair
    prompts = default if prompts is None else prompts
    j = JaxServer(jcfg, jparams, **kw).generate(jnp.asarray(prompts))
    t = BatchServer(tcfg, tparams, device="cpu", **kw).generate(prompts)
    return j, t


def _assert_same(j, t):
    np.testing.assert_array_equal(t["tokens"], np.asarray(j["tokens"]))
    assert t["stats"].decode_steps == j["stats"].decode_steps
    assert t["stats"].tokens_out == j["stats"].tokens_out


def test_serve_loop_matches_jax(pair):
    j, t = _both(pair, max_new_tokens=8)
    _assert_same(j, t)
    assert t["tokens"].shape == (2, 8) and t["tokens"].dtype == np.int32
    assert t["stats"].throughput_tok_s > 0
    assert t["stats"].decode_steps == 7
    # greedy decode is reproducible
    _, tcfg, tparams = pair[1], pair[2], pair[3]
    again = BatchServer(tcfg, tparams, max_new_tokens=8,
                        device="cpu").generate(pair[4])
    np.testing.assert_array_equal(again["tokens"], t["tokens"])


def test_serve_eos_masks_finished_lanes_and_early_exits(pair):
    """The EOS regression of tests/test_runtime.py, on both servers."""
    _, ref = _both(pair, max_new_tokens=8)
    toks = ref["tokens"]
    # a mid-sequence EOS: lane 0's second greedy token
    eos, pad = int(toks[0, 1]), -1
    j, t = _both(pair, max_new_tokens=8, eos_id=eos, pad_id=pad)
    _assert_same(j, t)
    got, stats = t["tokens"], t["stats"]
    for lane in range(got.shape[0]):
        hits = np.where(got[lane] == eos)[0]
        if len(hits):
            assert (got[lane, hits[0] + 1:] == pad).all()
    assert stats.tokens_out <= got.size
    assert stats.decode_steps <= got.shape[1] - 1
    assert stats.per_token_ms == pytest.approx(
        stats.decode_s / max(stats.decode_steps, 1) * 1e3)
    # immediate EOS on every lane where both lanes start alike, else on
    # one lane of a batch of one: decode stops after one step at most
    one = pair[4][:1]
    first = BatchServer(pair[2], pair[3], max_new_tokens=8,
                        device="cpu").generate(one)["tokens"][0]
    j, t = _both(pair, prompts=one, max_new_tokens=8, eos_id=int(first[1]),
                 pad_id=pad)
    _assert_same(j, t)
    assert t["stats"].decode_steps == 1
    assert t["tokens"].shape == (1, 2)
    j, t = _both(pair, prompts=one, max_new_tokens=8, eos_id=int(first[0]),
                 pad_id=pad)
    _assert_same(j, t)
    assert t["stats"].decode_steps == 0 and t["tokens"].shape == (1, 1)


def test_step_builders_match_registry(pair):
    _, _, tcfg, tparams, prompts = pair
    logits, cache = build_prefill_step(tcfg)(tparams, torch.from_numpy(
        prompts))
    want, _ = treg.prefill(tcfg, tparams, torch.from_numpy(prompts))
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    tok = logits.argmax(-1)
    got, cache = build_decode_step(tcfg)(tparams, tok, cache)
    assert got.shape == logits.shape and cache["len"] == prompts.shape[1] + 1


def test_server_lands_on_cuda_unless_asked(pair, monkeypatch):
    _, _, tcfg, tparams, _ = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchServer(tcfg, tparams)
    with pytest.raises(ValueError, match="params on cpu"):
        BatchServer(tcfg, tparams, device="meta")
    assert BatchServer(tcfg, tparams, device="cpu").device.type == "cpu"
