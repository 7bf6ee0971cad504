"""The port's recurrentgemma (``repro_torch.models.rglru``) against the
JAX package's on the CPU.

Parameters come from JAX ``registry.init(cfg, PRNGKey(0))`` on the smoke
config in float32 and cross through numpy (``params_from_jax``); the
same tokens go to both packages.  ``forward`` logits, ``prefill`` logits
and cache (the recurrent state and the ring buffer), ``decode_step``
logits and the ``BatchServer``'s tokens, ``decode_steps`` and
``tokens_out`` must agree.  Prompts run shorter than, equal to and
longer than the smoke window of 8, so prefill takes both branches of
the ring buffer and decode writes over old slots.  Tolerance: 1e-4 on
float32 logits and state, as ``tests/test_torch_models.py``: the same
float32 arithmetic with sums in another order (the port's recurrence is
a loop over S where the JAX model runs an associative scan, and its
attention accumulates as the kernels do).
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
from repro_torch.models import rglru as trg
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.loop import BatchServer

ARCH = "recurrentgemma_9b"
LOGITS = dict(rtol=1e-4, atol=1e-4)
STEPS = 4


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype=torch.float32)
    jparams = jreg.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab, (2, 20 + STEPS)).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, tokens


def test_layer_kinds_and_specs_match_jax():
    from repro.models import rglru as jrg
    for get in ("get", "get_smoke"):
        jcfg, tcfg = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        assert trg.layer_kinds(tcfg) == jrg.layer_kinds(jcfg)
        assert tcfg.n_params() == jcfg.n_params()
    jspecs = jreg.param_specs(jconfigs.get_smoke(ARCH))
    tspecs = treg.param_specs(tconfigs.get_smoke(ARCH))
    assert jax.tree.map(lambda s: tuple(s.shape), jspecs) == tspecs
    # the float32 marker stands exactly where the JAX leaf is float32 in
    # a bfloat16 model
    f32 = jax.tree.map(lambda s: s.dtype == jnp.float32, jspecs)
    marked = {k: ({n: isinstance(x, trg.F32) for n, x in v.items()}
                  if isinstance(v, dict) else isinstance(v, trg.F32))
              for k, v in tspecs.items()}
    assert f32 == marked
    assert marked["rec"]["w_a"] and not marked["rec"]["w_main"]


def test_full_width_size():
    """10.44 B parameters at full width: what the chip run serves."""
    assert tconfigs.get(ARCH).n_params() == 10_444_877_824


def test_init_shapes_and_dtypes():
    cfg = tconfigs.get_smoke(ARCH)
    p = treg.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = treg.param_specs(cfg)
    for group in ("rec", "attn"):
        for k, shape in specs[group].items():
            t = p[group][k]
            assert tuple(t.shape) == tuple(shape), (group, k)
            want = torch.float32 if isinstance(shape, trg.F32) \
                else torch.bfloat16
            assert t.dtype == want, (group, k)
    assert bool((p["rec"]["lam"] == 0.7).all())
    assert p["embed"].dtype == torch.bfloat16


def test_forward_matches_jax(pair):
    jcfg, jparams, tcfg, tparams, tokens = pair
    want = jreg.forward(jcfg, jparams, jnp.asarray(tokens))
    got = treg.forward(tcfg, tparams, _t(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


@pytest.mark.parametrize("prompt_len", [5, 8, 12, 20])
def test_prefill_and_decode_match_jax(pair, prompt_len):
    """Prompts shorter than, equal to and past the window of 8: the ring
    buffer is padded, full or rolled, and decode writes over old slots."""
    jcfg, jparams, tcfg, tparams, tokens = pair
    assert jcfg.window == 8
    jl, jc = jreg.prefill(jcfg, jparams, jnp.asarray(tokens[:, :prompt_len]))
    tl, tc = treg.prefill(tcfg, tparams, _t(tokens[:, :prompt_len]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    assert tc["len"] == int(jc["len"]) == prompt_len

    def same_cache():
        for key in ("h", "conv", "k", "v"):
            assert tuple(tc[key].shape) == jc[key].shape, key
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **LOGITS)
    same_cache()
    for step in range(STEPS):
        tok = tokens[:, prompt_len + step]
        jl, jc = jreg.decode_step(jcfg, jparams, jnp.asarray(tok), jc)
        tl, tc = treg.decode_step(tcfg, tparams, _t(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        assert tc["len"] == int(jc["len"])
    same_cache()


def test_prefill_decode_matches_own_forward(pair):
    """As ``tests/test_smoke_archs.py`` holds the JAX package: decode
    after a prompt past the window reproduces the parallel logits."""
    _, _, tcfg, tparams, tokens = pair
    full = treg.forward(tcfg, tparams, _t(tokens))
    logits, cache = treg.prefill(tcfg, tparams, _t(tokens[:, :20]))
    np.testing.assert_allclose(logits.numpy(), full[:, 19].numpy(), **LOGITS)
    for step in range(STEPS):
        logits, cache = treg.decode_step(tcfg, tparams,
                                         _t(tokens[:, 20 + step]), cache)
        np.testing.assert_allclose(logits.numpy(), full[:, 20 + step].numpy(),
                                   **LOGITS)


def test_decode_step_writes_the_state_in_place(pair):
    _, _, tcfg, tparams, tokens = pair
    _, cache = treg.prefill(tcfg, tparams, _t(tokens[:, :12]))
    h_before, k_before = cache["h"], cache["k"]
    old = k_before[:, :, 12 % tcfg.window].clone()
    _, new = treg.decode_step(tcfg, tparams, _t(tokens[:, 12]), cache)
    assert new["h"] is h_before and new["k"] is k_before
    assert new["len"] == 13
    assert not torch.equal(k_before[:, :, 12 % tcfg.window], old)


def _servers(pair, prompts, **kw):
    jcfg, jparams, tcfg, tparams, _ = pair
    j = JaxServer(jcfg, jparams, **kw).generate(jnp.asarray(prompts))
    t = BatchServer(tcfg, tparams, device="cpu", **kw).generate(prompts)
    np.testing.assert_array_equal(t["tokens"], np.asarray(j["tokens"]))
    assert t["stats"].decode_steps == j["stats"].decode_steps
    assert t["stats"].tokens_out == j["stats"].tokens_out
    return t


def test_serve_matches_jax(pair):
    prompts = pair[4][:, :12]
    t = _servers(pair, prompts, max_new_tokens=6)
    assert t["tokens"].shape == (2, 6) and t["stats"].decode_steps == 5
    # EOS: lane 0's second greedy token ends that lane
    eos = int(t["tokens"][0, 1])
    t = _servers(pair, prompts, max_new_tokens=6, eos_id=eos, pad_id=-1)
    hits = np.where(t["tokens"][0] == eos)[0]
    assert (t["tokens"][0, hits[0] + 1:] == -1).all()
