"""The port's MoE (``repro_torch.models.moe`` and the transformer's MoE
layers) against the JAX package on the CPU.

Routing, capacity dispatch and the expert FFN against
``repro.models.moe`` on the same float32 inputs: top-k ids, the kept
mask and the scatter indices equal, the weights within 1e-6 (softmax's
``exp`` differs in the last bit between the two libraries), outputs and
the aux loss within 1e-5 x max(1, scale).  Cases with dropped slots (a
capacity below the load) and with tied router probabilities (integer
logits, so that equal logits are exactly equal in both libraries), where
the slot order decides which slots overflow.  Then olmoe_1b_7b and
moonshot_v1_16b_a3b on their smoke configs in float32, parameters from
JAX ``registry.init`` carried by ``params_from_jax``: ``forward`` with
its aux loss, ``prefill``, ``decode_step`` and ``BatchServer`` within
1e-4 x max(1, logit scale) (``tests/test_torch_models.py``'s bar), and
tokens, ``decode_steps`` and ``tokens_out`` equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.serve.loop import BatchServer as JaxServer
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.models.common import F32
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.loop import BatchServer

ARCHS = ["olmoe_1b_7b", "moonshot_v1_16b_a3b"]
STEPS = 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale)


# ------------------------------------------------------------- the layer


def _layer_cfg(**kw):
    """A small MoE: 16 experts, top 4, d_model 32, d_ff 24, float32."""
    base = dataclasses.replace(jconfigs.get_smoke("olmoe_1b_7b"),
                               d_model=32, d_ff=24, n_experts=16, top_k=4,
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke("olmoe_1b_7b"),
                               d_model=32, d_ff=24, n_experts=16, top_k=4,
                               dtype=torch.float32, **kw)
    return base, tcfg


def _layer_inputs(case: str):
    """(jcfg, tcfg, numpy params, x (B, S, D)) for a routing case."""
    rng = np.random.default_rng({"random": 0, "drops": 1, "ties": 2}[case])
    jcfg, tcfg = _layer_cfg(capacity_factor={"random": 2.0, "drops": 0.5,
                                             "ties": 1.0}[case])
    d, e, f = jcfg.d_model, jcfg.n_experts, jcfg.d_ff
    p = {"w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    if case == "ties":
        # small integers: every logit is exact in float32 whatever the
        # order of the sum, so equal logits (and probabilities) are equal
        # bit for bit in both libraries; four columns repeat others
        x = rng.integers(-2, 3, (2, 24, d)).astype(np.float64)
        router = rng.integers(-1, 2, (d, e)).astype(np.float64) / 8
        router[:, [3, 7, 9, 12]] = router[:, [5, 0, 9, 2]]
        router[:, 9] = router[:, 1]
    else:
        x = rng.standard_normal((2, 24, d))
        router = rng.standard_normal((d, e)) / np.sqrt(d)
    p["router"] = router
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return jcfg, tcfg, p, x.astype(np.float32)


CASES = ["random", "drops", "ties"]


def test_capacity_matches_jax():
    jcfg, tcfg = _layer_cfg()
    for t in (1, 2, 4, 7, 24, 48, 256, 4096):
        for factor in (0.5, 1.0, 1.25, 8.0):
            j = dataclasses.replace(jcfg, capacity_factor=factor)
            c = dataclasses.replace(tcfg, capacity_factor=factor)
            assert tmoe.capacity(t, c) == jmoe._capacity(t, j), (t, factor)
    # olmoe at full width: 640 places in the serve cell's prefill (4 x
    # 1,024 tokens), 8 in its decode (4 tokens)
    olmoe = tconfigs.get("olmoe_1b_7b")
    assert tmoe.capacity(4096, olmoe) == 640
    assert tmoe.capacity(4, olmoe) == 8


@pytest.mark.parametrize("case", CASES)
def test_route_and_dispatch_match_jax(case):
    jcfg, tcfg, p, x = _layer_inputs(case)
    xt = x.reshape(-1, x.shape[-1])
    t = xt.shape[0]
    cap = jmoe._capacity(t, jcfg)
    jids, jw, jaux = jmoe._route(jnp.asarray(xt), jnp.asarray(p["router"]),
                                 jcfg)
    ids, w, aux = tmoe.route(_t(xt), _t(p["router"]), tcfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    _close(aux.numpy(), jaux, 1e-5)
    jidx, jkeep = jmoe._dispatch_indices(jids, t, cap, jcfg)
    idx, keep = tmoe.dispatch_indices(ids, cap, tcfg.n_experts)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    dropped = int((~keep).sum())
    if case == "random":
        assert dropped == 0
    else:
        assert dropped > 0, case
    if case == "ties":
        probs = torch.softmax(_t(xt) @ _t(p["router"]), dim=-1)
        top = probs.gather(1, ids)
        nxt = probs.sort(dim=-1, descending=True).values[:, tcfg.top_k]
        # a tie across the top-k boundary: the lower expert was taken
        assert bool((top[:, -1] == nxt).any())


@pytest.mark.parametrize("case", CASES)
def test_moe_ffn_matches_reference(case):
    jcfg, tcfg, p, x = _layer_inputs(case)
    jy, jaux = jmoe.moe_ffn_reference(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    y, aux = tmoe.moe_ffn(tcfg, {k: _t(v) for k, v in p.items()}, _t(x))
    assert y.shape == x.shape and y.dtype == torch.float32
    _close(y.numpy(), jy, 1e-5)
    _close(aux.numpy(), jaux, 1e-5)
    y2, none = tmoe.moe_ffn(tcfg, {k: _t(v) for k, v in p.items()}, _t(x),
                            aux=False)
    assert none is None and torch.equal(y, y2)


def test_dropped_slots_contribute_nothing():
    """With every probability tied (a zero router) all tokens pick the
    same experts in the same order; past the capacity a token's slots
    are dropped and its FFN output is exactly 0."""
    jcfg, tcfg, p, x = _layer_inputs("random")
    p = {k: _t(v) for k, v in p.items()}
    p["router"] = torch.zeros_like(p["router"])
    y, _ = tmoe.moe_ffn(tcfg, p, _t(x))
    t = x.shape[0] * x.shape[1]
    cap = tmoe.capacity(t, tcfg)
    ids, _, _ = tmoe.route(_t(x).reshape(t, -1), p["router"], tcfg)
    assert bool((ids == torch.arange(tcfg.top_k)).all())
    flat = y.reshape(t, -1)
    assert bool((flat[cap:] == 0).all()) and bool((flat[:cap] != 0).any())


def test_bfloat16_layer_routes_in_float32():
    """In a bfloat16 model the router stays float32 and routes the
    bfloat16 activations in float32; the output takes the input's
    dtype."""
    jcfg, tcfg, p, x = _layer_inputs("random")
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    tp = {k: _t(v).to(torch.bfloat16) for k, v in p.items()}
    tp["router"] = _t(p["router"])
    xb = _t(x).to(torch.bfloat16)
    y, aux = tmoe.moe_ffn(cfg, tp, xb)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    jp["router"] = jnp.asarray(p["router"])
    jy, _ = jmoe.moe_ffn_reference(
        dataclasses.replace(jcfg, dtype=jnp.bfloat16), jp,
        jnp.asarray(x, jnp.bfloat16))
    _close(y.float().numpy(), np.asarray(jy, np.float32), 5e-2)


def test_sharded_path_raises():
    """The expert-parallel path (A12.1) under a logical (2, 1) mesh: each
    batch row is a shard routed at its own capacity, as JAX's
    ``_local_moe`` on that row's tokens, within 1e-5 x max(1, scale);
    aux is the shards' mean.  At (1, 1) it is ``moe_ffn_reference``."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import ctx as tctx
    jcfg, tcfg, p, x = _layer_inputs("drops")
    tp = {k: _t(v) for k, v in p.items()}
    with tctx.use_mesh(make_test_mesh(1, 1)):
        one = tmoe.moe_ffn(tcfg, tp, _t(x))
    assert all(torch.equal(a, b) for a, b in
               zip(one, tmoe.moe_ffn_reference(tcfg, tp, _t(x))))
    with tctx.use_mesh(make_test_mesh(2, 1)):
        y, aux = tmoe.moe_ffn_sharded(tcfg, tp, _t(x))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    s = x.shape[1]
    outs = [jmoe._local_moe(jnp.asarray(x[i]), jp, jcfg,
                            jmoe._capacity(s, jcfg)) for i in range(2)]
    _close(y.numpy(), np.stack([np.asarray(o[0]) for o in outs]), 1e-5)
    _close(aux.numpy(), np.mean([float(o[1]) for o in outs]), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_one_shard_is_the_unsharded_dispatch(case, dtype):
    """``moe_ffn_reference``, and ``moe_ffn`` under a (1, 1) mesh, equal
    the dispatch written on (T, D) with no shard axis
    (``tests/moe_dispatch_2d.py``) bit for bit: outputs, aux loss and the
    gradients of x and of every weight."""
    from moe_dispatch_2d import grads, moe_2d

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import ctx as tctx
    _, tcfg, p, x = _layer_inputs(case)
    cfg = dataclasses.replace(tcfg, dtype=dtype)
    tp = {k: _t(v).to(torch.float32 if k == "router" else dtype)
          for k, v in p.items()}
    want = grads(moe_2d, cfg, tp, _t(x).to(dtype))
    with tctx.use_mesh(make_test_mesh(1, 1)):
        on_mesh = grads(tmoe.moe_ffn, cfg, tp, _t(x).to(dtype))
    for got in (grads(tmoe.moe_ffn_reference, cfg, tp, _t(x).to(dtype)),
                on_mesh):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert all(torch.equal(got[2][n], g) for n, g in want[2].items())


# ------------------------------------------------------------- the models


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_sizes_and_router_dtype(arch):
    for get in ("get", "get_smoke"):
        j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert t.n_params() == j.n_params()
    jspecs = jreg.param_specs(jconfigs.get_smoke(arch))
    tspecs = treg.param_specs(tconfigs.get_smoke(arch))
    assert jax.tree.map(lambda s: tuple(s.shape), jspecs) == tspecs
    assert "mlp" not in tspecs["layers"]
    assert isinstance(tspecs["layers"]["moe"]["router"], F32)
    assert jspecs["layers"]["moe"]["router"].dtype == jnp.float32
    p = treg.init(tconfigs.get_smoke(arch),
                  torch.Generator().manual_seed(0), device="cpu")
    assert p["layers"]["moe"]["router"].dtype == torch.float32
    assert p["layers"]["moe"]["w_gate"].dtype == torch.bfloat16
    assert tuple(p["layers"]["moe"]["w_down"].shape) == \
        tspecs["layers"]["moe"]["w_down"]


def test_olmoe_full_width_size():
    """6.919 B parameters at full width (13.84 GB in bfloat16): what the
    chip run serves."""
    assert tconfigs.get("olmoe_1b_7b").n_params() == 6_919_096_320


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_keeps_the_router_float32(arch):
    tree = jax.tree.map(np.asarray,
                        jreg.init(jconfigs.get_smoke(arch),
                                  jax.random.PRNGKey(2)))
    got = params_from_jax(tconfigs.get_smoke(arch), tree, device="cpu")
    router = got["layers"]["moe"]["router"]
    assert router.dtype == torch.float32
    np.testing.assert_array_equal(router.numpy(),
                                  tree["layers"]["moe"]["router"])
    assert got["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["layers"]["moe"]["w_up"].view(torch.int16).numpy(),
        tree["layers"]["moe"]["w_up"].view(np.int16))


def _pair(arch, **overrides):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32,
                               **overrides)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=torch.float32,
                               **overrides)
    jparams = jreg.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab, (2, 12 + STEPS)).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, tokens


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def test_forward_and_aux_match_jax(pair):
    jcfg, jparams, tcfg, tparams, tokens = pair
    jl, jaux = jreg.forward(jcfg, jparams, jnp.asarray(tokens),
                            return_aux=True)
    tl, taux = treg.forward(tcfg, tparams, _t(tokens), return_aux=True)
    _close(tl.numpy(), jl, 1e-4)
    _close(taux.numpy(), jaux, 1e-5)
    assert float(taux) > 0
    np.testing.assert_array_equal(
        treg.forward(tcfg, tparams, _t(tokens)).numpy(), tl.numpy())


def test_prefill_and_decode_match_jax(pair):
    jcfg, jparams, tcfg, tparams, tokens = pair
    jl, jc = jreg.prefill(jcfg, jparams, jnp.asarray(tokens[:, :12]))
    tl, tc = treg.prefill(tcfg, tparams, _t(tokens[:, :12]))
    _close(tl.numpy(), jl, 1e-4)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key].numpy(), jc[key], 1e-4)
    for step in range(STEPS):
        tok = tokens[:, 12 + step]
        jl, jc = jreg.decode_step(jcfg, jparams, jnp.asarray(tok), jc)
        tl, tc = treg.decode_step(tcfg, tparams, _t(tok), tc)
        _close(tl.numpy(), jl, 1e-4)
        assert tc["len"] == int(jc["len"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_own_forward(arch):
    """As ``tests/test_smoke_archs.py`` holds the JAX package, with its
    capacity factor of 8: prefill and decode route other token counts
    than the forward, so no slot may drop."""
    _, _, tcfg, tparams, tokens = _pair(arch, capacity_factor=8.0)
    full = treg.forward(tcfg, tparams, _t(tokens))
    logits, cache = treg.prefill(tcfg, tparams, _t(tokens[:, :12]),
                                 max_len=12 + STEPS)
    _close(logits.numpy(), full[:, 11].numpy(), 1e-4)
    for step in range(STEPS):
        logits, cache = treg.decode_step(tcfg, tparams,
                                         _t(tokens[:, 12 + step]), cache)
        _close(logits.numpy(), full[:, 12 + step].numpy(), 1e-4)


def test_serve_matches_jax(pair):
    jcfg, jparams, tcfg, tparams, tokens = pair
    prompts = tokens[:, :12]
    j = JaxServer(jcfg, jparams, max_new_tokens=6).generate(
        jnp.asarray(prompts))
    t = BatchServer(tcfg, tparams, max_new_tokens=6,
                    device="cpu").generate(prompts)
    np.testing.assert_array_equal(t["tokens"], np.asarray(j["tokens"]))
    assert t["stats"].decode_steps == j["stats"].decode_steps == 5
    assert t["stats"].tokens_out == j["stats"].tokens_out
