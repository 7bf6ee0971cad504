"""The port's seamless_m4t_medium (``repro_torch.models.encdec``) against
the JAX package on the CPU.

Parameters come from JAX ``registry.init`` on the smoke config in
float32 and cross through numpy (``params_from_jax``); the same tokens
and frame embeddings (numpy, from a seed, ``enc_len(S)`` frames) go to
both packages.  ``encode``, ``forward``, ``prefill`` and its cache (self
and cross K/V), ``decode_step`` and the ``BatchServer``'s tokens,
``decode_steps`` and ``tokens_out`` must agree, within 1e-4 x max(1,
scale), as ``tests/test_torch_models.py`` holds the dense family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import encdec as jed
from repro.models import registry as jreg
from repro.serve.loop import BatchServer as JaxServer
from repro_torch import configs as tconfigs
from repro_torch.models import encdec as ted
from repro_torch.models import registry as treg
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.loop import BatchServer

ARCH = "seamless_m4t_medium"
SEQ, STEPS = 12, 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=1e-4):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype=torch.float32)
    jparams = jreg.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab, (2, SEQ + STEPS)).astype(np.int32)
    fe = rng.standard_normal(
        (2, jed.enc_len(jcfg, SEQ), jcfg.frontend_dim)).astype(np.float32)
    return jcfg, jparams, tcfg, tparams, tokens, fe


def test_specs_sizes_and_lengths_match_jax():
    for get in ("get", "get_smoke"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        assert t.n_params() == j.n_params()
        for s in (1, 12, 255, 256, 1024, 1056, 4096):
            assert ted.enc_len(t, s) == jed.enc_len(j, s)
        for b, s in ((2, 16), (4, 1056)):
            want = jax.tree.map(lambda x: tuple(x.shape),
                                jreg.cache_specs(j, b, s))
            assert treg.cache_specs(t, b, s) == want
    jspecs = jreg.param_specs(jconfigs.get_smoke(ARCH))
    tspecs = treg.param_specs(tconfigs.get_smoke(ARCH))
    assert jax.tree.map(lambda s: tuple(s.shape), jspecs) == tspecs
    # 0.979 B parameters at full width (1.96 GB in bfloat16); the serve
    # cell's 1,024-token prompts take 256 frames
    assert tconfigs.get(ARCH).n_params() == 978_806_784
    assert ted.enc_len(tconfigs.get(ARCH), 1024) == 256
    p = treg.init(tconfigs.get_smoke(ARCH), torch.Generator().manual_seed(0),
                  device="cpu")
    for group in ("enc", "dec"):
        for k, shape in tspecs[group].items():
            if not isinstance(shape, dict):
                assert tuple(p[group][k].shape) == shape, (group, k)
                assert p[group][k].dtype == torch.bfloat16
    assert bool((p["dec"]["ln_x"] == 0).all())


def test_encode_matches_jax(pair):
    jcfg, jparams, tcfg, tparams, _, fe = pair
    want = jed.encode(jcfg, jparams, jnp.asarray(fe))
    got = ted.encode(tcfg, tparams, _t(fe))
    assert tuple(got.shape) == want.shape
    _close(got.numpy(), want)


def test_forward_matches_jax(pair):
    jcfg, jparams, tcfg, tparams, tokens, fe = pair
    want, jaux = jreg.forward(jcfg, jparams, jnp.asarray(tokens),
                              frontend_embeds=jnp.asarray(fe),
                              return_aux=True)
    got, aux = treg.forward(tcfg, tparams, _t(tokens),
                            frontend_embeds=_t(fe), return_aux=True)
    _close(got.numpy(), want)
    assert float(aux) == float(jaux) == 0.0
    with pytest.raises(ValueError, match="frontend embeds"):
        treg.forward(tcfg, tparams, _t(tokens))


def test_prefill_and_decode_match_jax(pair):
    """The cross cache holds the frames prefill was given (``enc_len(S)``),
    not ``cache_specs``' ``enc_len(max_len)``, in both packages."""
    jcfg, jparams, tcfg, tparams, tokens, fe = pair
    jl, jc = jreg.prefill(jcfg, jparams, jnp.asarray(tokens[:, :SEQ]),
                          frontend_embeds=jnp.asarray(fe))
    tl, tc = treg.prefill(tcfg, tparams, _t(tokens[:, :SEQ]),
                          frontend_embeds=_t(fe))
    _close(tl.numpy(), jl)
    assert tc["xk"].shape[2] == fe.shape[1]

    def same_cache():
        for key in ("k", "v", "xk", "xv"):
            assert tuple(tc[key].shape) == jc[key].shape, key
            _close(tc[key].numpy(), jc[key])
    same_cache()
    for step in range(STEPS):
        tok = tokens[:, SEQ + step]
        jl, jc = jreg.decode_step(jcfg, jparams, jnp.asarray(tok), jc)
        tl, tc = treg.decode_step(tcfg, tparams, _t(tok), tc)
        _close(tl.numpy(), jl)
        assert tc["len"] == int(jc["len"])
    same_cache()


def test_prefill_decode_matches_own_forward(pair):
    """As ``tests/test_smoke_archs.py`` holds the JAX package: decode
    after prefill reproduces the parallel logits; a full cache raises."""
    _, _, tcfg, tparams, tokens, fe = pair
    full = treg.forward(tcfg, tparams, _t(tokens), frontend_embeds=_t(fe))
    logits, cache = treg.prefill(tcfg, tparams, _t(tokens[:, :SEQ]),
                                 frontend_embeds=_t(fe), max_len=SEQ + STEPS)
    _close(logits.numpy(), full[:, SEQ - 1].numpy())
    xk = cache["xk"]
    for step in range(STEPS):
        logits, cache = treg.decode_step(tcfg, tparams,
                                         _t(tokens[:, SEQ + step]), cache)
        _close(logits.numpy(), full[:, SEQ + step].numpy())
    assert cache["xk"] is xk
    with pytest.raises(ValueError, match="all are used"):
        treg.decode_step(tcfg, tparams, _t(tokens[:, 0]), cache)


def test_serve_matches_jax(pair):
    """The frame embeddings go to both servers as numpy."""
    jcfg, jparams, tcfg, tparams, tokens, fe = pair
    prompts = tokens[:, :SEQ]
    j = JaxServer(jcfg, jparams, max_new_tokens=6).generate(
        jnp.asarray(prompts), frontend_embeds=fe)
    t = BatchServer(tcfg, tparams, max_new_tokens=6,
                    device="cpu").generate(prompts, frontend_embeds=fe)
    np.testing.assert_array_equal(t["tokens"], np.asarray(j["tokens"]))
    assert t["stats"].decode_steps == j["stats"].decode_steps == 5
    assert t["stats"].tokens_out == j["stats"].tokens_out
