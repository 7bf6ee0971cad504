"""The port's models against the JAX package on the CPU.

Each function of ``repro_torch.models.common`` against its JAX
counterpart, the configs field by field, and the dense transformer on
the four dense smoke configs in float32: parameters come from JAX
``registry.init(cfg, PRNGKey(0))`` and cross through numpy
(``params_from_jax``), the same tokens go to both packages, and
``forward`` logits, ``prefill`` logits and cache, and four
``decode_step``s' logits must agree.  Tolerance: 1e-4 relative and
absolute on float32 logits, as ``tests/test_smoke_archs.py`` holds the
JAX package's own prefill/decode to its forward: the same float32
arithmetic with sums taken in another order (the port's attention
accumulates as the kernels do, the JAX models use jnp attention), about
1e-6 relative per operation over two or three layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcm
from repro.models import registry as jreg
from repro_torch import configs as tconfigs
from repro_torch.models import common as tcm
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_jax

DENSE = ["qwen3_4b", "phi3_medium_14b", "glm4_9b", "deepseek_coder_33b"]
OTHER = [a for a in jconfigs.ARCHS if a not in DENSE]
F32 = dict(rtol=2e-6, atol=2e-6)        # one float32 function, same order
LOGITS = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ----------------------------------------------------------- common.py


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norms_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tol = F32 if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    for jfn, tfn in ((jcm.rms_norm, tcm.rms_norm),
                     (jcm.head_rms_norm, tcm.head_rms_norm)):
        want = jfn(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1e-6)
        got = tfn(_t(x).to(tdt), _t(w).to(tdt), 1e-6)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("positions", ["1d", "2d"])
def test_rope_matches_jax(positions):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = (np.arange(7) + 3 if positions == "1d"
           else rng.integers(0, 1000, (2, 7)))
    for theta in (10_000.0, 1_000_000.0):
        np.testing.assert_allclose(
            tcm.rope_freqs(16, theta).numpy(),
            np.asarray(jcm.rope_freqs(16, theta)), **F32)
        want = jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = tcm.apply_rope(_t(x), _t(pos), theta)
        # angles up to 1e3 rad: cos/sin of a float32 argument differ in
        # the last bits between libraries
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_mlp_and_loss_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("w_gate", (16, 24)), ("w_up", (16, 24)),
                      ("w_down", (24, 16)))}
    want = jcm.mlp_forward({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x))
    got = tcm.mlp_forward({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    logits = rng.standard_normal((3, 4, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 4)).astype(np.int32)
    for z in (0.0, 1e-4):
        want = jcm.softmax_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels), z_loss=z)
        got = tcm.softmax_cross_entropy(_t(logits), _t(labels), z_loss=z)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_initializers_have_the_jax_scales():
    """The two frameworks draw different numbers from a seed; the shapes,
    dtypes and scales agree (std within 3% on 65,536 draws)."""
    g = torch.Generator().manual_seed(0)
    w = tcm.dense_init(g, (4, 64, 256), torch.bfloat16, in_axis=(0, 1))
    assert w.shape == (4, 64, 256) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) * np.sqrt(256) - 1) < 0.03
    e = tcm.embed_init(g, (256, 256), torch.float32)
    assert abs(float(e.std()) / 0.02 - 1) < 0.03
    j = jcm.dense_init(jax.random.PRNGKey(0), (4, 64, 256), jnp.float32,
                       in_axis=(0, 1))
    assert abs(float(jnp.std(j)) * np.sqrt(256) - 1) < 0.03


# ----------------------------------------------------------- configs


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_copy_the_jax_values(arch):
    for jget, tget in ((jconfigs.get, tconfigs.get),
                       (jconfigs.get_smoke, tconfigs.get_smoke)):
        j, t = dataclasses.asdict(jget(arch)), dataclasses.asdict(tget(arch))
        assert j.pop("dtype") == jnp.bfloat16
        assert t.pop("dtype") == torch.bfloat16
        assert j == t
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    cfg = tconfigs.get(arch)
    assert cfg.hd == jconfigs.get(arch).hd
    assert cfg.q_per_kv == jconfigs.get(arch).q_per_kv


@pytest.mark.parametrize("arch", DENSE)
def test_n_params_and_specs_match_jax(arch):
    for get in ("get", "get_smoke"):
        j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert t.n_params() == j.n_params()
    specs = treg.param_specs(tconfigs.get_smoke(arch))
    jspecs = jreg.param_specs(jconfigs.get_smoke(arch))
    assert jax.tree.map(lambda s: tuple(s.shape), jspecs) == specs


def test_qwen3_4b_full_width_size():
    """4.41 B parameters at full width: what the chip run serves."""
    assert tconfigs.get("qwen3_4b").n_params() == 4_411_424_256


@pytest.mark.parametrize("arch", OTHER)
def test_non_dense_families_raise(arch):
    """Every non-dense family builds its parameters with the JAX
    package's shapes and lands on the CPU when asked (the families'
    parity: tests/test_torch_{moe,vlm,encdec,rglru,xlstm}.py); the MoE,
    VLM and encoder-decoder families train: every leaf gets a finite
    gradient (the train step's parity:
    tests/test_torch_train_families.py)."""
    cfg = tconfigs.get_smoke(arch)
    specs = treg.param_specs(cfg)
    jspecs = jreg.param_specs(jconfigs.get_smoke(arch))
    assert jax.tree.map(lambda s: tuple(s.shape), jspecs) == specs
    p = treg.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["embed"].device.type == "cpu"
    assert tuple(p["embed"].shape) == specs["embed"]
    if cfg.family in ("rglru", "xlstm"):
        return
    from repro_torch.launch.shapes import frontend_tokens
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import grads_of
    tokens = torch.arange(8, dtype=torch.int64)[None] % cfg.vocab
    nf = frontend_tokens(cfg, tokens.shape[1])
    fe = (torch.randn((1, nf, cfg.frontend_dim),
                      generator=torch.Generator().manual_seed(1))
          if nf else None)
    grads, ce = grads_of(cfg, p, tokens, tokens, fe)
    assert bool(torch.isfinite(ce))
    for g, leaf in zip(tree_leaves(grads), tree_leaves(p)):
        assert g.shape == leaf.shape and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("field,value,item", [
    ("n_experts", 4, "A11"), ("frontend", "patch", "A11"),
    ("tp_attention", True, "A12"), ("sp_decode", True, "A12"),
    ("moe_ffn_sharded", None, "A12")])
def test_dense_options_not_ported_raise(field, value, item):
    """The mesh options raise, naming ROADMAP A12: ``tp_attention`` and
    ``sp_decode`` in ``check_dense``, the expert-parallel MoE path when
    called.  The MoE layers and the patch frontend (A11) are ported:
    ``check_dense`` takes them and the parameter tree grows their
    leaves."""
    base = tconfigs.get_smoke("qwen3_4b")
    if field == "moe_ffn_sharded":
        from repro_torch.models import moe
        cfg = tconfigs.get_smoke("olmoe_1b_7b")
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            moe.moe_ffn_sharded(cfg, {}, torch.zeros(1, 2, cfg.d_model))
        return
    cfg = dataclasses.replace(base, **{field: value})
    if item == "A11":
        ttf.check_dense(cfg)
        specs = treg.param_specs(cfg)
        assert ("moe" in specs["layers"]) == (field == "n_experts")
        assert ("frontend_proj" in specs) == (field == "frontend")
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ttf.check_dense(cfg)


def test_init_lands_on_cuda_unless_asked(monkeypatch):
    cfg = tconfigs.get_smoke("qwen3_4b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        treg.init(cfg, torch.Generator())
    p = treg.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["embed"].device.type == "cpu"
    assert p["embed"].dtype == torch.bfloat16


def test_params_from_jax_checks_the_tree():
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen3_4b"),
                              dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jreg.init(
        dataclasses.replace(jconfigs.get_smoke("qwen3_4b"),
                            dtype=jnp.float32), jax.random.PRNGKey(0)))
    ok = params_from_jax(cfg, tree, device="cpu")
    np.testing.assert_array_equal(ok["layers"]["wq"].numpy(),
                                  tree["layers"]["wq"])
    bad = dict(tree, extra=np.zeros(1))
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(cfg, bad, device="cpu")
    bad = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(cfg, bad, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3_4b", "recurrentgemma_9b",
                                  "xlstm_1_3b", "olmoe_1b_7b"])
def test_params_from_jax_keeps_float32_leaves(arch):
    """In a bfloat16 model the leaves that JAX keeps in float32 (the
    recurrent families' gate weights, the MoE router) stay float32, bit
    for bit; every
    other leaf, and every leaf of the dense family, takes the model's
    dtype."""
    jcfg = jconfigs.get_smoke(arch)
    tree = jax.tree.map(np.asarray, jreg.init(jcfg, jax.random.PRNGKey(2)))
    got = params_from_jax(tconfigs.get_smoke(arch), tree, device="cpu")
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    n_f32 = 0
    for path, leaf in leaves:
        t = got
        for key in path:
            t = t[key.key]
        if leaf.dtype == np.float32:
            n_f32 += 1
            assert t.dtype == torch.float32, path
            np.testing.assert_array_equal(t.numpy(), leaf)
        else:
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          leaf.view(np.int16))
    assert n_f32 == {"qwen3_4b": 0, "recurrentgemma_9b": 5,
                     "xlstm_1_3b": 4, "olmoe_1b_7b": 1}[arch]


def test_params_from_jax_carries_bfloat16_bits():
    cfg = tconfigs.get_smoke("qwen3_4b")
    tree = jax.tree.map(np.asarray, jreg.init(jconfigs.get_smoke("qwen3_4b"),
                                              jax.random.PRNGKey(3)))
    got = params_from_jax(cfg, tree, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["embed"].view(torch.int16).numpy(),
        tree["embed"].view(np.int16))


# ----------------------------------------------------------- the transformer


def _pair(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=torch.float32)
    jparams = jreg.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


SEQ, BATCH, STEPS = 12, 2, 4


@pytest.fixture(scope="module", params=DENSE)
def dense_pair(request):
    jcfg, jparams, tcfg, tparams = _pair(request.param)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab, (BATCH, SEQ + STEPS)).astype(
        np.int32)
    return jcfg, jparams, tcfg, tparams, tokens


def test_forward_matches_jax(dense_pair):
    jcfg, jparams, tcfg, tparams, tokens = dense_pair
    want = jreg.forward(jcfg, jparams, jnp.asarray(tokens))
    got = treg.forward(tcfg, tparams, _t(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_prefill_and_decode_match_jax(dense_pair):
    jcfg, jparams, tcfg, tparams, tokens = dense_pair
    jl, jc = jreg.prefill(jcfg, jparams, jnp.asarray(tokens[:, :SEQ]))
    tl, tc = treg.prefill(tcfg, tparams, _t(tokens[:, :SEQ]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    assert tc["len"] == int(jc["len"]) == SEQ
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **LOGITS)
    for step in range(STEPS):
        tok = tokens[:, SEQ + step]
        jl, jc = jreg.decode_step(jcfg, jparams, jnp.asarray(tok), jc)
        tl, tc = treg.decode_step(tcfg, tparams, _t(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        assert tc["len"] == int(jc["len"])
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **LOGITS)


def test_prefill_decode_matches_own_forward(dense_pair):
    """As ``tests/test_smoke_archs.py`` holds the JAX package: decode
    after prefill reproduces the parallel logits."""
    _, _, tcfg, tparams, tokens = dense_pair
    full = treg.forward(tcfg, tparams, _t(tokens))
    logits, cache = treg.prefill(tcfg, tparams, _t(tokens[:, :SEQ]),
                                 max_len=SEQ + STEPS)
    np.testing.assert_allclose(logits.numpy(), full[:, SEQ - 1].numpy(),
                               **LOGITS)
    for step in range(STEPS):
        logits, cache = treg.decode_step(tcfg, tparams,
                                         _t(tokens[:, SEQ + step]), cache)
        np.testing.assert_allclose(logits.numpy(),
                                   full[:, SEQ + step].numpy(), **LOGITS)
    with pytest.raises(ValueError, match="all are used"):
        treg.decode_step(tcfg, tparams, _t(tokens[:, 0]), cache)


def test_decode_step_writes_the_cache_in_place(dense_pair):
    _, _, tcfg, tparams, tokens = dense_pair
    _, cache = treg.prefill(tcfg, tparams, _t(tokens[:, :SEQ]))
    k_before = cache["k"]
    _, new = treg.decode_step(tcfg, tparams, _t(tokens[:, SEQ]), cache)
    assert new["k"] is k_before and new["len"] == SEQ + 1
    assert bool(k_before[:, :, SEQ].abs().sum() > 0)
