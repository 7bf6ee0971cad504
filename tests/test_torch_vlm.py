"""The port's pixtral_12b (the transformer with its patch frontend)
against the JAX package on the CPU.

Parameters come from JAX ``registry.init`` on the smoke config in
float32 and cross through numpy (``params_from_jax``); the same tokens
and patch embeddings (numpy, from a seed: ``min(n_frontend_tokens, S //
2)`` of them, as ``tests/test_smoke_archs.py`` and
``repro.launch.shapes`` reckon) go to both packages.  ``embed_tokens``,
``forward``, ``prefill`` and its cache, ``decode_step`` and the
``BatchServer``'s tokens, ``decode_steps`` and ``tokens_out`` must agree,
logits within 1e-4 x max(1, logit scale), as
``tests/test_torch_models.py`` holds the dense family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.models import transformer as jtf
from repro.serve.loop import BatchServer as JaxServer
from repro_torch import configs as tconfigs
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.loop import BatchServer

ARCH = "pixtral_12b"
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
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab, (2, SEQ + STEPS)).astype(np.int32)
    nf = min(jcfg.n_frontend_tokens, SEQ // 2)
    fe = rng.standard_normal((2, nf, jcfg.frontend_dim)).astype(np.float32)
    return jcfg, jparams, tcfg, tparams, tokens, fe


def test_specs_and_sizes_match_jax():
    for get in ("get", "get_smoke"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        assert t.n_params() == j.n_params()
    jspecs = jreg.param_specs(jconfigs.get_smoke(ARCH))
    tspecs = treg.param_specs(tconfigs.get_smoke(ARCH))
    assert jax.tree.map(lambda s: tuple(s.shape), jspecs) == tspecs
    assert tspecs["frontend_proj"] == (32, 64)
    # 12.253 B parameters at full width (24.51 GB in bfloat16)
    assert tconfigs.get(ARCH).n_params() == 12_253_025_280
    p = treg.init(tconfigs.get_smoke(ARCH), torch.Generator().manual_seed(0),
                  device="cpu")
    assert p["frontend_proj"].dtype == torch.bfloat16
    assert tuple(p["frontend_proj"].shape) == tspecs["frontend_proj"]


def test_embed_tokens_matches_jax(pair):
    jcfg, jparams, tcfg, tparams, tokens, fe = pair
    want = jtf.embed_tokens(jcfg, jparams, jnp.asarray(tokens),
                            jnp.asarray(fe))
    got = ttf.embed_tokens(tcfg, tparams, _t(tokens), _t(fe))
    _close(got.numpy(), want, 1e-6)
    nf = fe.shape[1]
    # the positions past the patches keep their token embeddings
    np.testing.assert_array_equal(got[:, nf:].numpy(),
                                  tparams["embed"][_t(tokens)][:, nf:].numpy())
    # float64 patches are cast to the model's dtype first, as jnp.dot's
    # operand is
    got64 = ttf.embed_tokens(tcfg, tparams, _t(tokens), _t(fe).double())
    assert got64.dtype == torch.float32 and torch.equal(got64, got)


@pytest.mark.parametrize("with_patches", [True, False])
def test_forward_matches_jax(pair, with_patches):
    jcfg, jparams, tcfg, tparams, tokens, fe = pair
    fe = fe if with_patches else None
    want, jaux = jreg.forward(jcfg, jparams, jnp.asarray(tokens),
                              frontend_embeds=fe, return_aux=True)
    got, aux = treg.forward(tcfg, tparams, _t(tokens),
                            frontend_embeds=None if fe is None else _t(fe),
                            return_aux=True)
    _close(got.numpy(), want)
    assert float(aux) == float(jaux) == 0.0


def test_prefill_and_decode_match_jax(pair):
    jcfg, jparams, tcfg, tparams, tokens, fe = pair
    jl, jc = jreg.prefill(jcfg, jparams, jnp.asarray(tokens[:, :SEQ]),
                          frontend_embeds=jnp.asarray(fe))
    tl, tc = treg.prefill(tcfg, tparams, _t(tokens[:, :SEQ]),
                          frontend_embeds=_t(fe))
    _close(tl.numpy(), jl)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key].numpy(), jc[key])
    for step in range(STEPS):
        tok = tokens[:, SEQ + step]
        jl, jc = jreg.decode_step(jcfg, jparams, jnp.asarray(tok), jc)
        tl, tc = treg.decode_step(tcfg, tparams, _t(tok), tc)
        _close(tl.numpy(), jl)
        assert tc["len"] == int(jc["len"])


def test_prefill_decode_matches_own_forward(pair):
    _, _, tcfg, tparams, tokens, fe = pair
    full = treg.forward(tcfg, tparams, _t(tokens), frontend_embeds=_t(fe))
    logits, cache = treg.prefill(tcfg, tparams, _t(tokens[:, :SEQ]),
                                 frontend_embeds=_t(fe), max_len=SEQ + STEPS)
    _close(logits.numpy(), full[:, SEQ - 1].numpy())
    for step in range(STEPS):
        logits, cache = treg.decode_step(tcfg, tparams,
                                         _t(tokens[:, SEQ + step]), cache)
        _close(logits.numpy(), full[:, SEQ + step].numpy())


def test_serve_matches_jax(pair):
    """The patch embeddings go to both servers as numpy."""
    jcfg, jparams, tcfg, tparams, tokens, fe = pair
    prompts = tokens[:, :SEQ]
    j = JaxServer(jcfg, jparams, max_new_tokens=6).generate(
        jnp.asarray(prompts), frontend_embeds=fe)
    t = BatchServer(tcfg, tparams, max_new_tokens=6,
                    device="cpu").generate(prompts, frontend_embeds=fe)
    np.testing.assert_array_equal(t["tokens"], np.asarray(j["tokens"]))
    assert t["stats"].decode_steps == j["stats"].decode_steps == 5
    assert t["stats"].tokens_out == j["stats"].tokens_out
    # the patches change what is said
    plain = BatchServer(tcfg, tparams, max_new_tokens=6,
                        device="cpu").generate(prompts)
    assert not np.array_equal(plain["tokens"], t["tokens"])
