"""Training the MoE, VLM, encoder-decoder and recurrent families: the
port against the JAX package on the CPU.

olmoe_1b_7b and moonshot_v1_16b_a3b (token-choice MoE: the loss adds
``router_aux_coef`` times the load-balancing loss), pixtral_12b (patch
frontend), seamless_m4t_medium (encoder-decoder over audio frames),
recurrentgemma_9b (RG-LRU and windowed attention) and xlstm_1_3b (mLSTM
and sLSTM; the port remats each layer where the JAX package remats each
group, which changes no number) on their smoke configs, parameters from
JAX ``registry.init`` carried by ``params_from_jax``, the same batches
with their frontend embeddings (both packages' ``SyntheticLMData`` draw
them from one numpy generator):
one and three steps of ``build_train_step``, with and without remat,
against JAX's, at ``tests/test_torch_train.py``'s tolerances (float32:
loss and ``grad_norm`` 1e-5 relative, parameters and AdamW moments 1e-4 x
max(1, the leaf's largest |value|); bfloat16 2e-2).  Then the traps of
training these families: slots dropped by the capacity, experts that no
token reaches and a leaf that the loss does not reach get the gradient
``jax.grad`` gives them (zeros where unreached, which AdamW still
decays); the trainer draws the frontend embeddings the JAX trainer
draws; and ``launch/shapes.py`` equals the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import SyntheticLMData as JData
from repro.launch import shapes as jshp
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro.train.step import _loss_fn as jloss
from repro.train.step import build_train_step as jbuild
from repro_torch import configs as tconfigs
from repro_torch.data import SyntheticLMData as TData
from repro_torch.launch import shapes as tshp
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as tregistry
from repro_torch.models.common import F32
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.train.step import build_train_step as tbuild
from repro_torch.train.step import grads_of
from test_torch_train import LR, TOL, _cfgs, _close_leaves, _rel, _states

ARCHS = ["olmoe_1b_7b", "moonshot_v1_16b_a3b", "pixtral_12b",
         "seamless_m4t_medium", "recurrentgemma_9b", "xlstm_1_3b"]
FRONTEND = ["pixtral_12b", "seamless_m4t_medium"]


def _data(jcfg, tcfg, seq_len: int, global_batch: int,
          frontend: bool = True):
    nf = jshp.frontend_tokens(jcfg, seq_len) if frontend else 0
    kw = dict(seq_len=seq_len, global_batch=global_batch,
              frontend_dim=jcfg.frontend_dim, frontend_tokens=nf)
    return (JData(vocab=jcfg.vocab, **kw),
            TData(vocab=tcfg.vocab, device="cpu", **kw))


def _train(arch: str, dtype: str, n_steps: int, *, remat: bool = False,
           seq_len: int = 32, global_batch: int = 4, frontend: bool = True,
           **overrides):
    """``n_steps`` of both packages' train step from the same state and
    batches, held at ``TOL[dtype]``; returns the port's parameters."""
    jcfg, tcfg = (dataclasses.replace(c, **overrides)
                  for c in _cfgs(dtype, remat, arch))
    (jp, jo), (tp, to) = _states(jcfg, tcfg)
    jstep = jax.jit(jbuild(jcfg, lr_kwargs=LR))
    tstep = tbuild(tcfg, lr_kwargs=LR)
    jd, td = _data(jcfg, tcfg, seq_len, global_batch, frontend)
    tol = TOL[dtype]
    for step in range(n_steps):
        jb, tb = jd.batch(step), td.batch(step)
        assert ("frontend_embeds" in tb) == (frontend and bool(
            jcfg.frontend))
        jp, jo, jm = jstep(jp, jo, jnp.int32(step), jb)
        tp, to, tm = tstep(tp, to, step, tb)
        for key in ("loss", "grad_norm"):
            assert _rel(jm[key], tm[key]) <= tol["scalar"], (step, key)
    _close_leaves(jp, tp, tol["leaf"])
    _close_leaves(jo["m"], to["m"], tol["leaf"])
    _close_leaves(jo["v"], to["v"], tol["leaf"])
    assert int(jo["count"]) == int(to["count"]) == n_steps
    return tp


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_float32(arch, n_steps, remat):
    _train(arch, "float32", n_steps, remat=remat)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_bfloat16(arch):
    tp = _train(arch, "bfloat16", 3)
    # bfloat16 but the leaves float32 in any model (``common.F32``: the MoE
    # router, the recurrent families' gate weights)
    _, tcfg = _cfgs("bfloat16", False, arch)
    specs = tree_leaves(tregistry.param_specs(tcfg))
    assert any(not isinstance(sp, F32) for sp in specs)
    assert [p.dtype for p in tree_leaves(tp)] == [
        torch.float32 if isinstance(sp, F32) else torch.bfloat16
        for sp in specs]


def _grads_both(arch: str, tokens: np.ndarray, fe=None, **overrides):
    """(JAX gradient tree, the port's ``grads_of`` tree) of the loss on
    the same float32 parameters and inputs."""
    jcfg, tcfg = (dataclasses.replace(c, **overrides)
                  for c in _cfgs("float32", False, arch))
    (jp, _), (tp, _) = _states(jcfg, tcfg)
    jfe = None if fe is None else jnp.asarray(fe)
    jg = jax.grad(lambda p: jloss(jcfg, p, jnp.asarray(tokens),
                                  jnp.asarray(tokens), jfe)[0])(jp)
    t = torch.from_numpy(tokens)
    tg, _ = grads_of(tcfg, tp, t, t,
                     None if fe is None else torch.from_numpy(fe))
    return jg, tg


def test_moe_dropped_slots_get_no_gradient_like_jax():
    """A capacity factor of 0.5 drops about half of olmoe's slots: the
    router's gradient flows through the kept slots' gathered weights
    only, as through JAX's ``top_k`` and scatter; three train steps
    agree with JAX's."""
    seen = []
    inner = tmoe.dispatch_indices

    def keeping(ids, cap, n_experts):
        idx, keep = inner(ids, cap, n_experts)
        seen.append(int((~keep).sum()))
        return idx, keep
    tmoe.dispatch_indices = keeping
    try:
        _train("olmoe_1b_7b", "float32", 3, capacity_factor=0.5)
    finally:
        tmoe.dispatch_indices = inner
    assert seen and min(seen) > 0, seen
    tokens = np.random.default_rng(4).integers(0, 256, (2, 24)).astype(
        np.int32)
    jg, tg = _grads_both("olmoe_1b_7b", tokens, capacity_factor=0.5)
    _close_leaves(jg, tg, TOL["float32"]["leaf"])


def test_unreached_experts_get_zero_gradients_like_jax():
    """Three tokens take six slots of eight experts, so at least two
    experts of each layer see no token: their ``bmm`` gradients are
    zeros (not missing), equal to ``jax.grad``'s, and AdamW decays them
    as JAX's step does."""
    tokens = np.array([[5, 17, 200]], dtype=np.int32)
    jg, tg = _grads_both("olmoe_1b_7b", tokens)
    _close_leaves(jg, tg, TOL["float32"]["leaf"])
    w = tg["layers"]["moe"]["w_gate"]                  # (L, E, D, F)
    idle = (w.abs().amax(dim=(2, 3)) == 0).sum(dim=1)
    assert bool((idle >= 2).all()), idle
    _train("olmoe_1b_7b", "float32", 2, seq_len=3, global_batch=1)


def test_unreached_leaf_gets_zero_gradient_like_jax():
    """pixtral_12b fed no patch embeddings: ``frontend_proj`` is not
    reached, gets zeros as from ``jax.grad``, and two train steps (AdamW
    decaying it) agree with JAX's."""
    tokens = np.random.default_rng(5).integers(0, 256, (2, 16)).astype(
        np.int32)
    jg, tg = _grads_both("pixtral_12b", tokens)
    _close_leaves(jg, tg, TOL["float32"]["leaf"])
    assert not bool(tg["frontend_proj"].any())
    _train("pixtral_12b", "float32", 2, frontend=False)


@pytest.mark.parametrize("arch", FRONTEND)
def test_trainer_data_carries_the_frontend_like_jax(arch, tmp_path):
    """The trainer's data draws the frontend embeddings that the JAX
    trainer's does (``frontend_tokens`` patches or frames of
    ``frontend_dim``), bit for bit; the trainer runs two steps on them
    with finite losses."""
    kw = dict(n_steps=2, seq_len=32, global_batch=2, checkpoint_every=100,
              log_every=100)
    jtr = JTrainer(jconfigs.get_smoke(arch),
                   JTrainerConfig(checkpoint_dir=str(tmp_path / "j"), **kw),
                   log_fn=lambda _s: None)
    ttr = Trainer(tconfigs.get_smoke(arch),
                  TrainerConfig(checkpoint_dir=str(tmp_path / "t"), **kw),
                  log_fn=lambda _s: None, device="cpu")
    for step in (0, 1):
        jb, tb = jtr.data.batch(step), ttr.data.batch(step)
        assert set(jb) == set(tb) == {"tokens", "labels", "frontend_embeds"}
        for key in jb:
            np.testing.assert_array_equal(tb[key].numpy(),
                                          np.asarray(jb[key]))
    out = ttr.run()
    assert out["final_step"] == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])


# ---------------------------------------------------------------- shapes


def _shape_tree(tree):
    """Every leaf of a spec tree as a shape tuple (a JAX
    ``ShapeDtypeStruct``'s, or the port's tuple)."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    return tuple(getattr(tree, "shape", tree))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_shapes_match_jax(arch):
    """``SHAPES``, ``applicable``, ``frontend_tokens`` and
    every cell's ``input_specs`` (shapes, and dtypes outside the cache)
    equal the JAX package's."""
    assert {k: dataclasses.astuple(v) for k, v in tshp.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jshp.SHAPES.items()}
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for seq in (1, 2, 7, 64, 300, 2048, 4096):
        assert tshp.frontend_tokens(tcfg, seq) == \
            jshp.frontend_tokens(jcfg, seq), seq
    for name, shape in tshp.SHAPES.items():
        assert tshp.applicable(tcfg, shape) == \
            jshp.applicable(jcfg, jshp.SHAPES[name])
        got = tshp.input_specs(tcfg, shape)
        want = jshp.input_specs(jcfg, jshp.SHAPES[name])
        assert set(got) == set(want), name
        for key, spec in want.items():
            if key == "cache":
                assert _shape_tree(got[key]) == _shape_tree(spec), name
                continue
            shp, dt = got[key]
            assert shp == tuple(spec.shape), (name, key)
            assert str(dt).replace("torch.", "") == str(spec.dtype)
