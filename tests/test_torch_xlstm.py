"""The port's xLSTM (``repro_torch.models.xlstm``) against the JAX
package's on the CPU.

Parameters come from JAX ``registry.init(cfg, PRNGKey(0))`` on the smoke
config (4 blocks, one sLSTM every 2) in float32 and cross through numpy
(``params_from_jax``); the same tokens go to both packages.  ``forward``
logits, ``prefill`` logits and recurrent state (mLSTM C, n and conv
tail, sLSTM h, c, n, m), ``decode_step`` logits and the
``BatchServer``'s tokens, ``decode_steps`` and ``tokens_out`` must
agree.  The helpers ``causal_conv`` and ``mlstm_step`` are held per
function.  Tolerance: 1e-4 on float32 logits and state, as
``tests/test_torch_models.py`` (the same float32 arithmetic with sums
in another order); 2e-6 for a single function.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.models import xlstm as jxl
from repro.serve.loop import BatchServer as JaxServer
from repro_torch import configs as tconfigs
from repro_torch.models import registry as treg
from repro_torch.models import xlstm as txl
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.loop import BatchServer

ARCH = "xlstm_1_3b"
LOGITS = dict(rtol=1e-4, atol=1e-4)
F32 = dict(rtol=2e-6, atol=2e-6)
SEQ, STEPS = 12, 4


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype=torch.float32)
    jparams = jreg.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    tokens = np.random.default_rng(6).integers(
        0, jcfg.vocab, (2, SEQ + STEPS)).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, tokens


def test_specs_and_dtypes_match_jax():
    for get in ("get", "get_smoke"):
        jcfg, tcfg = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        assert tcfg.n_params() == jcfg.n_params()
    jspecs = jreg.param_specs(jconfigs.get_smoke(ARCH))
    tspecs = treg.param_specs(tconfigs.get_smoke(ARCH))
    assert jax.tree.map(lambda s: tuple(s.shape), jspecs) == tspecs
    f32 = jax.tree.map(lambda s: s.dtype == jnp.float32, jspecs)
    marked = {k: ({n: isinstance(x, txl.F32) for n, x in v.items()}
                  if isinstance(v, dict) else isinstance(v, txl.F32))
              for k, v in tspecs.items()}
    assert f32 == marked
    assert marked["mlstm"]["w_gates"] and marked["slstm"]["r"]
    jcache = jxl.cache_specs(jconfigs.get_smoke(ARCH), 3, 0)
    tcache = txl.cache_specs(tconfigs.get_smoke(ARCH), 3, 0)
    assert {k: tuple(s.shape) for k, s in jcache.items()} == tcache


def test_full_width_size():
    """3.63 B parameters at full width (the config's q/k/v projections are
    full d_inner x d_inner): what the chip run serves."""
    assert tconfigs.get(ARCH).n_params() == 3_633_969_488


def test_init_shapes_dtypes_and_biases():
    cfg = tconfigs.get_smoke(ARCH)
    p = treg.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = treg.param_specs(cfg)
    for group in ("mlstm", "slstm"):
        for k, shape in specs[group].items():
            t = p[group][k]
            assert tuple(t.shape) == tuple(shape), (group, k)
            want = torch.float32 if isinstance(shape, txl.F32) \
                else torch.bfloat16
            assert t.dtype == want, (group, k)
    h = cfg.n_heads
    assert bool((p["mlstm"]["b_gates"][:, :h] == -2.0).all())
    assert bool((p["mlstm"]["b_gates"][:, h:] == 3.0).all())


def test_causal_conv_and_mlstm_step_match_jax():
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for state in (None, st):
        jo, js = jxl.causal_conv(jnp.asarray(u), jnp.asarray(w),
                                 None if state is None else jnp.asarray(state))
        to, ts = txl.causal_conv(_t(u), _t(w),
                                 None if state is None else _t(state))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **F32)
    q, k, v = (rng.standard_normal((2, 3, 8)).astype(np.float32)
               for _ in range(3))
    ig, fg = (rng.standard_normal((2, 3)).astype(np.float32) for _ in range(2))
    c = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    n = rng.standard_normal((2, 3, 8)).astype(np.float32)
    jh, (jc, jn) = jxl.mlstm_step(*(jnp.asarray(x)
                                    for x in (q, k, v, ig, fg, c, n)))
    th, (tc, tn) = txl.mlstm_step(*(_t(x) for x in (q, k, v, ig, fg, c, n)))
    for got, want in ((th, jh), (tc, jc), (tn, jn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_forward_matches_jax(pair):
    jcfg, jparams, tcfg, tparams, tokens = pair
    want = jreg.forward(jcfg, jparams, jnp.asarray(tokens))
    got = treg.forward(tcfg, tparams, _t(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_prefill_and_decode_match_jax(pair):
    jcfg, jparams, tcfg, tparams, tokens = pair
    jl, jc = jreg.prefill(jcfg, jparams, jnp.asarray(tokens[:, :SEQ]))
    tl, tc = treg.prefill(tcfg, tparams, _t(tokens[:, :SEQ]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    assert tc["len"] == int(jc["len"]) == SEQ

    def same_cache():
        for key in ("m_c", "m_n", "m_conv", "s_h"):
            assert tuple(tc[key].shape) == jc[key].shape, key
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **LOGITS)
    same_cache()
    for step in range(STEPS):
        tok = tokens[:, SEQ + step]
        jl, jc = jreg.decode_step(jcfg, jparams, jnp.asarray(tok), jc)
        tl, tc = treg.decode_step(tcfg, tparams, _t(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        assert tc["len"] == int(jc["len"])
    same_cache()


def test_prefill_decode_matches_own_forward(pair):
    _, _, tcfg, tparams, tokens = pair
    full = treg.forward(tcfg, tparams, _t(tokens))
    logits, cache = treg.prefill(tcfg, tparams, _t(tokens[:, :SEQ]))
    np.testing.assert_allclose(logits.numpy(), full[:, SEQ - 1].numpy(),
                               **LOGITS)
    m_c = cache["m_c"]
    for step in range(STEPS):
        logits, cache = treg.decode_step(tcfg, tparams,
                                         _t(tokens[:, SEQ + step]), cache)
        np.testing.assert_allclose(logits.numpy(),
                                   full[:, SEQ + step].numpy(), **LOGITS)
    assert cache["m_c"] is m_c                  # the state moved in place


def _servers(pair, prompts, **kw):
    jcfg, jparams, tcfg, tparams, _ = pair
    j = JaxServer(jcfg, jparams, **kw).generate(jnp.asarray(prompts))
    t = BatchServer(tcfg, tparams, device="cpu", **kw).generate(prompts)
    np.testing.assert_array_equal(t["tokens"], np.asarray(j["tokens"]))
    assert t["stats"].decode_steps == j["stats"].decode_steps
    assert t["stats"].tokens_out == j["stats"].tokens_out
    return t


def test_serve_matches_jax(pair):
    prompts = pair[4][:, :SEQ]
    t = _servers(pair, prompts, max_new_tokens=6)
    assert t["tokens"].shape == (2, 6) and t["stats"].decode_steps == 5
    eos = int(t["tokens"][0, 1])
    t = _servers(pair, prompts, max_new_tokens=6, eos_id=eos, pad_id=-1)
    hits = np.where(t["tokens"][0] == eos)[0]
    assert (t["tokens"][0, hits[0] + 1:] == -1).all()
