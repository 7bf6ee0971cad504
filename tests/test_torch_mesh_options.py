"""The mesh options of the port on a logical mesh, held to the JAX
package on the CPU in float32 (smoke configs).

- ``tp_attention``: the forward at (1, 1) against JAX's under a
  one-device mesh with Auto axes (JAX's ``make_test_mesh`` builds
  Explicit axes, on which its ``with_sharding_constraint`` raises), and
  bit-equal to the port's forward without the option; at (1, 3) (heads
  padded) and (2, 2) against the port's forward without the option.
  Bound 1e-4 x max(1, logit scale), the JAX package's own test's.
- ``decode_attention_sp``: at m = 1 against JAX's within 1e-5; at m = 2
  and 4 against m = 1; a cache that does not split raises.
- ``moe_ffn_sharded``: at (1, 1) bit-equal to ``moe_ffn_reference`` and
  within 1e-5 of JAX's ``moe_ffn_sharded``; at (2, 2), (1, 2) and
  (2, 1), prefill- and decode-shaped, against JAX's ``_local_moe`` and
  ``_capacity`` composed per shard in the documented order (contiguous
  batch blocks in (pod, data) order, sequence blocks when the sequence
  is sharded, tokens (b, s) row-major), within 1e-5 x max(1, scale),
  with each shard's kept mask equal and aux the shards' mean.
- A ``Trainer`` elastic restore from a (2, 1) mesh to a (1, 2) one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.parallel import ctx as jctx
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import restore, save
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.models.convert import params_from_jax
from repro_torch.parallel import ctx as tctx
from repro_torch.parallel import sharding as tshd

TP_TOL = 1e-4
SP_TOL = 1e-5
MOE_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale)


def _jax_mesh():
    """The one CPU device as a (1, 1) mesh with Auto axes."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _pair(arch, **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32,
                               **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=torch.float32,
                               **over)
    jparams = jreg.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


# ------------------------------------------------------------ tp_attention


@pytest.fixture(scope="module")
def tp_pair():
    jcfg, jparams, tcfg, tparams = _pair("qwen3_4b", tp_attention=True)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 16))
    return jcfg, jparams, tcfg, tparams, tokens.astype(np.int32)


def test_tp_attention_one_shard_matches_jax(tp_pair):
    jcfg, jparams, tcfg, tparams, tokens = tp_pair
    with jctx.use_mesh(_jax_mesh()):
        want = jreg.forward(jcfg, jparams, jnp.asarray(tokens))
    with tctx.use_mesh(make_test_mesh(1, 1)):
        got = treg.forward(tcfg, tparams, _t(tokens))
    _close(got.numpy(), want, TP_TOL)
    base = treg.forward(dataclasses.replace(tcfg, tp_attention=False),
                        tparams, _t(tokens))
    assert torch.equal(got, base)
    # without a mesh the weights pass unchanged
    assert torch.equal(treg.forward(tcfg, tparams, _t(tokens)), base)


@pytest.mark.parametrize("shape", [(1, 3), (2, 2)])
def test_tp_attention_pads_heads_and_matches_base(tp_pair, shape):
    _, _, tcfg, tparams, tokens = tp_pair
    from repro_torch.models.transformer import tp_attn_weights
    lp = {k: v[0] for k, v in tparams["layers"].items()
          if not isinstance(v, dict)}
    with tctx.use_mesh(make_test_mesh(*shape)):
        wq, wk, wv, wo, h_eff = tp_attn_weights(tcfg, lp)
        got = treg.forward(tcfg, tparams, _t(tokens))
    tp = shape[1]
    assert h_eff == -(-tcfg.n_heads // tp) * tp
    assert wq.shape[1] == wk.shape[1] == wv.shape[1] == wo.shape[0] == h_eff
    assert not wo[tcfg.n_heads:].any() and not wq[:, tcfg.n_heads:].any()
    torch.testing.assert_close(wk[:, :tcfg.n_heads],
                               lp["wk"].repeat_interleave(tcfg.q_per_kv, 1),
                               rtol=0, atol=0)
    base = treg.forward(dataclasses.replace(tcfg, tp_attention=False),
                        tparams, _t(tokens))
    _close(got.numpy(), base.numpy(), TP_TOL)


def test_tp_attention_trains_as_base(tp_pair):
    """The training path: a train step under tp_attention (and
    gather_weights_once, whose specs are computed and change no value)
    at (1, 3) against the step without the options: loss, grad norm and
    the updated parameters."""
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.step import build_train_step
    _, _, tcfg, tparams, tokens = tp_pair
    batch = {"tokens": _t(tokens).long(), "labels": _t(tokens).long()}
    cfg = dataclasses.replace(tcfg, remat=True, gather_weights_once=True)
    base = dataclasses.replace(cfg, tp_attention=False,
                               gather_weights_once=False)
    out = {}
    for c, mesh in ((cfg, make_test_mesh(1, 3)), (base, None)):
        params = tree_map(torch.clone, tparams)
        with tctx.use_mesh(mesh):
            params, _, m = build_train_step(c)(params, adamw_init(params), 10,
                                               batch)
        out[c.tp_attention] = (params, m)
    (p1, m1), (p0, m0) = out[True], out[False]
    for key in ("loss", "grad_norm"):
        _close(m1[key].numpy(), m0[key].numpy(), 1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p0)):
        _close(a.numpy(), b.numpy(), 1e-4)


# ------------------------------------------------------------ sp_decode


def _sp_inputs(s=24, b=2, h=4, hkv=2, hd=16, seed=7):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, 1, h, hd), (b, s, hkv, hd),
                             (b, s, hkv, hd)))
    return q, k, v


@pytest.mark.parametrize("cache_len", [1, 13, 24])
def test_decode_attention_sp_matches_jax(cache_len):
    q, k, v = _sp_inputs()
    with jctx.use_mesh(_jax_mesh()):
        want = jattn.decode_attention_sp(*map(jnp.asarray, (q, k, v)),
                                         jnp.int32(cache_len))
    tq, tk, tv = map(_t, (q, k, v))
    got = {}
    for m in (1, 2, 4):
        with tctx.use_mesh(make_test_mesh(1, m)):
            got[m] = tattn.decode_attention_sp(tq, tk, tv, cache_len)
        assert got[m].shape == (2, 1, 4, 16)
    _close(got[1].numpy(), want, SP_TOL)
    for m in (2, 4):
        _close(got[m].numpy(), got[1].numpy(), SP_TOL)
    # without a mesh: decode_attention itself
    assert torch.equal(tattn.decode_attention_sp(tq, tk, tv, cache_len),
                       tattn.decode_attention(tq, tk, tv, cache_len))


def test_decode_attention_sp_needs_even_shards():
    tq, tk, tv = map(_t, _sp_inputs(s=30))
    with tctx.use_mesh(make_test_mesh(1, 4)):
        with pytest.raises(ValueError, match="does not split"):
            tattn.decode_attention_sp(tq, tk, tv, 5)


def test_sp_decode_steps_match_jax_and_shards():
    """qwen3_4b's decode with ``sp_decode``: at (1, 1) against JAX's
    under an Auto mesh, at (1, 2) against (1, 1), 1e-4 x scale."""
    jcfg, jparams, tcfg, tparams = _pair("qwen3_4b", sp_decode=True)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 12))
    tokens = tokens.astype(np.int32)
    with jctx.use_mesh(_jax_mesh()):
        jl, jc = jreg.prefill(jcfg, jparams, jnp.asarray(tokens[:, :8]))
    caches = {m: treg.prefill(tcfg, tparams, _t(tokens[:, :8]))[1]
              for m in (1, 2)}
    for step in range(4):
        tok = tokens[:, 8 + step]
        with jctx.use_mesh(_jax_mesh()):
            jl, jc = jreg.decode_step(jcfg, jparams, jnp.asarray(tok), jc)
        got = {}
        for m in (1, 2):
            with tctx.use_mesh(make_test_mesh(1, m)):
                got[m], caches[m] = treg.decode_step(tcfg, tparams, _t(tok),
                                                     caches[m])
        _close(got[1].numpy(), jl, TP_TOL)
        _close(got[2].numpy(), got[1].numpy(), TP_TOL)


# ------------------------------------------------------------ the MoE


def _moe_cfg(factor=0.5):
    """16 experts, top 4, d_model 32, d_ff 24, float32; capacity factor
    0.5 so shards drop slots."""
    over = dict(d_model=32, d_ff=24, n_experts=16, top_k=4,
                capacity_factor=factor)
    return (dataclasses.replace(jconfigs.get_smoke("olmoe_1b_7b"),
                                dtype=jnp.float32, **over),
            dataclasses.replace(tconfigs.get_smoke("olmoe_1b_7b"),
                                dtype=torch.float32, **over))


def _moe_inputs(b, s, seed=0):
    jcfg, tcfg = _moe_cfg()
    rng = np.random.default_rng(seed)
    d, e, f = jcfg.d_model, jcfg.n_experts, jcfg.d_ff
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    return jcfg, tcfg, p, x


def _keeping(monkeypatch):
    """The port's kept masks, by call of ``moe.dispatch_indices``."""
    kept, inner = [], tmoe.dispatch_indices

    def keeping(ids, cap, n_experts):
        idx, keep = inner(ids, cap, n_experts)
        kept.append(keep)
        return idx, keep
    monkeypatch.setattr(tmoe, "dispatch_indices", keeping)
    return kept


def test_moe_sharded_one_shard_is_the_reference():
    jcfg, tcfg, p, x = _moe_inputs(2, 24)
    tp = {k: _t(v) for k, v in p.items()}
    ref_y, ref_aux = tmoe.moe_ffn_reference(tcfg, tp, _t(x))
    with tctx.use_mesh(make_test_mesh(1, 1)):
        y, aux = tmoe.moe_ffn(tcfg, tp, _t(x))
        y1, aux1 = tmoe.moe_ffn(tcfg, tp, _t(x[:, :1]))
    assert torch.equal(y, ref_y) and torch.equal(aux, ref_aux)
    r1, a1 = tmoe.moe_ffn_reference(tcfg, tp, _t(x[:, :1]))
    assert torch.equal(y1, r1) and torch.equal(aux1, a1)
    with jctx.use_mesh(_jax_mesh()):
        jy, jaux = jmoe.moe_ffn_sharded(jcfg, {k: jnp.asarray(v)
                                               for k, v in p.items()},
                                        jnp.asarray(x))
    _close(y.numpy(), jy, MOE_TOL)
    _close(aux.numpy(), jaux, MOE_TOL)


def _jax_shards(jcfg, p, x, dp, m):
    """JAX's ``_local_moe`` on each shard in (pod, data), model order:
    (y (B, S, D), [aux], [kept mask]) of the shards."""
    b, s, d = x.shape
    ms = m if (s % m == 0 and s >= m and s > 1) else 1
    bl, sl = b // dp, s // ms
    cap = jmoe._capacity(max(bl * sl, 1), jcfg)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    y = np.zeros_like(x)
    auxes, keeps = [], []
    for i in range(dp):
        for j in range(ms):
            blk = (slice(i * bl, (i + 1) * bl), slice(j * sl, (j + 1) * sl))
            xt = jnp.asarray(x[blk].reshape(bl * sl, d))
            yl, a = jmoe._local_moe(xt, jp, jcfg, cap)
            ids, _, _ = jmoe._route(xt, jp["router"], jcfg)
            _, keep = jmoe._dispatch_indices(ids, bl * sl, cap, jcfg)
            y[blk] = np.asarray(yl).reshape(bl, sl, d)
            auxes.append(float(a))
            keeps.append(np.asarray(keep))
    return y, auxes, keeps


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1)])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_moe_sharded_matches_jax_per_shard(monkeypatch, shape, kind):
    dp, m = shape
    b, s = (4, 64) if kind == "prefill" else (64, 1)
    jcfg, tcfg, p, x = _moe_inputs(b, s, seed=1 if kind == "decode" else 0)
    want_y, want_aux, want_keep = _jax_shards(jcfg, p, x, dp, m)
    kept = _keeping(monkeypatch)
    with tctx.use_mesh(make_test_mesh(*shape)):
        y, aux = tmoe.moe_ffn(tcfg, {k: _t(v) for k, v in p.items()},
                              _t(x))
    _close(y.numpy(), want_y, MOE_TOL)
    _close(aux.numpy(), np.mean(want_aux), MOE_TOL)
    (keep,) = kept              # (shards, T*k); (T*k,) at one shard
    keep = keep.reshape(len(want_keep), -1)
    for got, want in zip(keep, want_keep):
        np.testing.assert_array_equal(got.numpy(), want)
    assert sum(int((~k).sum()) for k in want_keep) > 0


def test_moe_sharded_batch_must_divide_dp():
    _, tcfg, p, x = _moe_inputs(3, 8)
    with tctx.use_mesh(make_test_mesh(2, 2)):
        with pytest.raises(ValueError, match="does not split"):
            tmoe.moe_ffn(tcfg, {k: _t(v) for k, v in p.items()}, _t(x))


def test_moe_model_on_a_mesh_drops_per_shard(monkeypatch):
    """olmoe's smoke model: the forward under (2, 2) routes each of four
    shards at its own capacity (JAX's ``moe_ffn_sharded`` on a real
    mesh); at (1, 1) it is the unsharded forward, bit for bit."""
    jcfg, jparams, tcfg, tparams = _pair("olmoe_1b_7b")
    tokens = _t(np.random.default_rng(2).integers(0, 256, (4, 32)))
    base, base_aux = treg.forward(tcfg, tparams, tokens, return_aux=True)
    with tctx.use_mesh(make_test_mesh(1, 1)):
        one, one_aux = treg.forward(tcfg, tparams, tokens, return_aux=True)
    assert torch.equal(one, base) and torch.equal(one_aux, base_aux)
    kept = _keeping(monkeypatch)
    with tctx.use_mesh(make_test_mesh(2, 2)):
        four, _ = treg.forward(tcfg, tparams, tokens, return_aux=True)
    # two layers, four shards of 2 x 16 tokens each
    assert [tuple(k.shape) for k in kept] == [(4, 32 * tcfg.top_k)] * 2
    assert bool(torch.isfinite(four).all())


# ------------------------------------------------------------ elastic restore


def test_trainer_elastic_restore_across_meshes(tmp_path):
    """Save under a (2, 1) mesh, restore under (1, 2): the shardings are
    recomputed on the new mesh and checked, the leaves equal what was
    saved (``tests/test_runtime.py::test_elastic_restore_across_meshes``
    for the port)."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.train.step import train_state_shardings
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen3_4b"), remat=False)
    tcfg = TrainerConfig(n_steps=2, seq_len=8, global_batch=2,
                         checkpoint_dir=str(tmp_path),
                         checkpoint_async=False)
    tr = Trainer(cfg, tcfg, mesh=make_test_mesh(data=2, model=1),
                 log_fn=lambda _s: None, device="cpu")
    assert tr.p_sh == train_state_shardings(cfg, tr.mesh)[0]
    params, opt = tr.init_state()
    with tctx.use_mesh(tr.mesh):
        params, opt, _ = tr.step(params, opt, 0, tr.data.batch(0))
    tr.ckpt.save({"params": params, "opt": opt}, 1, blocking=True)
    tr.mesh = make_test_mesh(data=1, model=2)
    tr._build()
    assert tr.p_sh["embed"].mesh == tr.mesh
    assert tr.o_sh == train_state_shardings(cfg, tr.mesh)[1]
    got_p, got_o, step = tr._recover()
    assert step == 1
    for a, b in zip(tree_leaves({"p": got_p, "o": got_o}),
                    tree_leaves({"p": params, "o": opt})):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_checks_shardings(tmp_path):
    like = {"w": torch.zeros(4, 6), "n": torch.zeros(())}
    save(tmp_path, like, step=1)
    mesh = make_test_mesh(data=2, model=3)
    ok = {"w": tshd.Sharding(mesh, ("data", "model")),
          "n": tshd.Sharding(mesh, ())}
    tree, step, _ = restore(tmp_path, like, shardings=ok)
    assert step == 1 and torch.equal(tree["w"], like["w"])
    for bad, match in (
            (dict(ok, w=tshd.Sharding(mesh, ("pod", None))), "lacks"),
            (dict(ok, w=tshd.Sharding(mesh, ("model", None))), "splits"),
            ({"w": ok["w"]}, "does not match")):
        with pytest.raises(ValueError, match=match):
            restore(tmp_path, like, shardings=bad)
