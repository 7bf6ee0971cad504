"""The port's training path against the JAX package on the CPU.

The qwen3_4b smoke config, parameters from JAX ``registry.init`` carried
across by ``convert.params_from_jax``, the same batches (both packages'
``SyntheticLMData`` draw them from one numpy generator, bit for bit):
the learning-rate schedule, one and three train steps (loss,
``grad_norm``, lr, parameters and both AdamW moments), two microbatches,
the int8 gradient compression, and the runtime cases of
``tests/test_runtime.py`` on the port's ``Trainer``.

Tolerances.  float32: loss and ``grad_norm`` within 1e-5 relative (the
same float32 arithmetic with sums in another order; the port's attention
backward is the explicit formulas, JAX differentiates its jnp
attention); parameters and moments within 1e-4 x max(1, the leaf's
largest |value|), because AdamW's m / sqrt(v) turns a last-bit
difference in a near-zero gradient into a step of the size of lr.
bfloat16: 2e-2 on the same quantities (bf16 rounds at other places in
the two frameworks).  The schedule agrees within one float32 rounding
(the two frameworks' ``cos`` differ in the last bit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import SyntheticLMData as JData
from repro.models import registry as jreg
from repro.optim import adamw_init as jadamw_init
from repro.optim.compress import compress_grads as jcompress
from repro.optim.schedule import lr_schedule as jlr
from repro.train.step import build_train_step as jbuild
from repro_torch import configs as tconfigs
from repro_torch.data import SyntheticLMData as TData
from repro_torch.models import registry as treg
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw_init as tadamw_init
from repro_torch.optim import opt_state_specs
from repro_torch.optim.adamw import TensorSpec, tree_leaves
from repro_torch.optim.compress import compress_grads as tcompress
from repro_torch.optim.schedule import lr_schedule as tlr
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig
from repro_torch.train.step import build_train_step as tbuild
from repro_torch.train.step import grads_of, train_state_specs

LR = dict(peak_lr=1e-3, warmup=2, total=10)
TOL = {"float32": dict(scalar=1e-5, leaf=1e-4),
       "bfloat16": dict(scalar=2e-2, leaf=2e-2)}


def _cfgs(dtype: str, remat: bool = False, arch: str = "qwen3_4b"):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=jdt,
                                remat=remat),
            dataclasses.replace(tconfigs.get_smoke(arch), dtype=tdt,
                                remat=remat))


def _states(jcfg, tcfg):
    jp = jreg.init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return (jp, jadamw_init(jp)), (tp, tadamw_init(tp))


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_leaves(jtree, ttree, tol: float):
    jl, tl = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = _f32(a)
        b = b.float().numpy()
        assert a.shape == b.shape
        scale = max(1.0, float(np.abs(a).max()))
        assert float(np.abs(a - b).max()) <= tol * scale


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(a)), 1e-30)


def _run_steps(dtype, n_steps, *, n_microbatch=1, remat=False,
               global_batch=4, seq_len=32):
    jcfg, tcfg = _cfgs(dtype, remat)
    (jp, jo), (tp, to) = _states(jcfg, tcfg)
    jstep = jax.jit(jbuild(jcfg, n_microbatch=n_microbatch, lr_kwargs=LR))
    tstep = tbuild(tcfg, n_microbatch=n_microbatch, lr_kwargs=LR)
    jd = JData(vocab=jcfg.vocab, seq_len=seq_len, global_batch=global_batch)
    td = TData(vocab=tcfg.vocab, seq_len=seq_len, global_batch=global_batch,
               device="cpu")
    tol = TOL[dtype]
    for step in range(n_steps):
        jp, jo, jm = jstep(jp, jo, jnp.int32(step), jd.batch(step))
        tp, to, tm = tstep(tp, to, step, td.batch(step))
        for key in ("loss", "grad_norm"):
            assert _rel(jm[key], tm[key]) <= tol["scalar"], (step, key)
        assert _rel(jm["lr"], tm["lr"]) <= 3e-7 or float(jm["lr"]) == 0.0
    _close_leaves(jp, tp, tol["leaf"])
    _close_leaves(jo["m"], to["m"], tol["leaf"])
    _close_leaves(jo["v"], to["v"], tol["leaf"])
    assert int(jo["count"]) == int(to["count"]) == n_steps
    return tp


@pytest.mark.parametrize("kw", [{}, dict(peak_lr=3e-4, warmup=20, total=40),
                                dict(peak_lr=1e-3, warmup=5, total=30,
                                     floor_frac=0.2)])
def test_lr_schedule_matches_jax(kw):
    for step in range(41):
        want = float(jlr(jnp.int32(step), **kw))
        for got in (tlr(step, **kw),
                    tlr(torch.tensor(step, dtype=torch.int32), **kw)):
            assert got.dtype == torch.float32 and got.dim() == 0
            assert abs(float(got) - want) <= 3e-7 * abs(want), (step, kw)


def test_data_pipeline_bit_equal_to_jax():
    """Tokens, and the frontend embeddings where the batch carries them
    (a VLM's 8 patches or an encoder-decoder's 64 frames of width 12),
    bit-equal to JAX's ``SyntheticLMData``."""
    for nf, dim in ((0, 0), (8, 12), (64, 12)):
        kw = dict(vocab=256, seq_len=16, global_batch=4, seed=3,
                  frontend_dim=dim, frontend_tokens=nf)
        j, t = JData(**kw), TData(device="cpu", **kw)
        for step in (0, 7, 12):
            got, want = t.batch(step), j.batch(step)
            assert got["tokens"].dtype == torch.int32
            np.testing.assert_array_equal(got["tokens"].numpy(),
                                          np.asarray(want["tokens"]))
            assert torch.equal(got["labels"], got["tokens"])
            assert ("frontend_embeds" in got) == bool(nf)
            if nf:
                fe = got["frontend_embeds"]
                assert fe.dtype == torch.float32
                assert tuple(fe.shape) == (4, nf, dim)
                np.testing.assert_array_equal(
                    fe.numpy(), np.asarray(want["frontend_embeds"]))


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_jax_float32(n_steps, remat):
    _run_steps("float32", n_steps, remat=remat)


def test_train_step_matches_jax_bfloat16():
    tp = _run_steps("bfloat16", 3)
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(tp))


def test_train_step_two_microbatches_matches_jax():
    _run_steps("float32", 2, n_microbatch=2)


def test_params_and_moments_update_in_place():
    _, tcfg = _cfgs("float32")
    _, (tp, to) = _states(*_cfgs("float32"))
    ptrs = [t.data_ptr() for t in tree_leaves({"p": tp, "m": to["m"],
                                              "v": to["v"]})]
    step = tbuild(tcfg, lr_kwargs=LR)
    batch = TData(vocab=tcfg.vocab, seq_len=16, global_batch=2,
                  device="cpu").batch(0)
    tp2, to2, _ = step(tp, to, 1, batch)
    assert [t.data_ptr() for t in tree_leaves(
        {"p": tp2, "m": to2["m"], "v": to2["v"]})] == ptrs
    assert not any(p.requires_grad for p in tree_leaves(tp2))


def test_a_parameter_without_gradient_raises(monkeypatch):
    """A leaf that the loss does not reach gets a zero gradient, as
    ``jax.grad`` gives it (AdamW then decays it); a loss that reaches no
    leaf at all raises."""
    _, tcfg = _cfgs("float32")
    _, (tp, _) = _states(*_cfgs("float32"))
    tp["unused"] = torch.ones(3)
    batch = TData(vocab=tcfg.vocab, seq_len=8, global_batch=2,
                  device="cpu").batch(0)
    grads, _ = grads_of(tcfg, tp, batch["tokens"], batch["labels"], None)
    assert torch.equal(grads["unused"], torch.zeros(3))
    assert bool(grads["embed"].any())
    monkeypatch.setattr(treg, "forward", lambda cfg, params, tokens, **kw:
                        torch.zeros(*tokens.shape, cfg.vocab))
    with pytest.raises(RuntimeError, match="got no gradient"):
        grads_of(tcfg, tp, batch["tokens"], batch["labels"], None)


def test_compress_grads_matches_jax():
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((8, 5)).astype(np.float32),
             "b": {"c": (rng.standard_normal(7) * 1e-3).astype(np.float32)}}
    ef = {"a": rng.standard_normal((8, 5)).astype(np.float32) * 0.01,
          "b": {"c": np.zeros(7, np.float32)}}
    jd, je = jcompress(jax.tree.map(jnp.asarray, grads),
                       jax.tree.map(jnp.asarray, ef))
    t = lambda tree: {k: t(v) if isinstance(v, dict)  # noqa: E731
                      else torch.from_numpy(v) for k, v in tree.items()}
    td, te = tcompress(t(grads), t(ef))
    for a, b in zip(jax.tree.leaves((jd, je)),
                    tree_leaves({"d": td, "e": te})):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_state_specs():
    _, tcfg = _cfgs("float32")
    p_specs, o_specs = train_state_specs(tcfg)
    assert p_specs == treg.param_specs(tcfg)
    assert o_specs["count"] == TensorSpec((), torch.int32)
    leaves = tree_leaves(o_specs["m"])
    assert [s.shape for s in leaves] == [tuple(s) for s in
                                         tree_leaves(p_specs)]
    assert all(s.dtype == torch.float32 for s in leaves)
    assert opt_state_specs(p_specs) == o_specs


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_1_3b"])
def test_recurrent_smoke_models_backward_on_the_cpu(arch):
    """The recurrent families' plain versions stay differentiable on the
    CPU: ``loss.backward()`` gives every parameter a finite gradient (on
    the card the kernels' backward kernels carry it; their train steps are
    held to JAX's in tests/test_torch_train_families.py)."""
    _, tcfg = _cfgs("float32", arch=arch)
    params = treg.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    batch = TData(vocab=tcfg.vocab, seq_len=24, global_batch=2,
                  device="cpu").batch(0)
    grads, ce = grads_of(tcfg, params, batch["tokens"], batch["labels"],
                         None)
    assert torch.isfinite(ce)
    for g, p in zip(tree_leaves(grads), tree_leaves(params)):
        assert g.shape == p.shape and bool(torch.isfinite(g).all())


def test_remat_changes_nothing():
    jcfg, tcfg = _cfgs("float32")
    _, (tp, _) = _states(jcfg, tcfg)
    batch = TData(vocab=tcfg.vocab, seq_len=16, global_batch=2,
                  device="cpu").batch(3)
    plain = grads_of(tcfg, tp, batch["tokens"], batch["labels"], None)
    remat = grads_of(dataclasses.replace(tcfg, remat=True), tp,
                     batch["tokens"], batch["labels"], None)
    assert torch.equal(plain[1], remat[1])
    for a, b in zip(tree_leaves(plain[0]), tree_leaves(remat[0])):
        assert torch.equal(a, b)


# -- the runtime cases of tests/test_runtime.py, on the port ------------------


@pytest.fixture()
def small_cfg():
    return dataclasses.replace(tconfigs.get_smoke("qwen3_4b"), remat=False)


def test_trainer_loss_decreases(small_cfg, tmp_path):
    tcfg = TrainerConfig(n_steps=30, seq_len=32, global_batch=4,
                         checkpoint_every=1000,
                         checkpoint_dir=str(tmp_path), log_every=1000)
    out = Trainer(small_cfg, tcfg, log_fn=lambda s: None, device="cpu").run()
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_trainer_failure_restart_resumes_from_checkpoint(small_cfg,
                                                         tmp_path):
    tcfg = TrainerConfig(n_steps=25, seq_len=16, global_batch=4,
                         checkpoint_every=10, checkpoint_async=False,
                         checkpoint_dir=str(tmp_path), log_every=1000)
    inj = FailureInjector(fail_at_steps={17})
    tr = Trainer(small_cfg, tcfg, injector=inj, log_fn=lambda s: None,
                 device="cpu")
    out = tr.run()
    assert out["restarts"] == 1
    steps = [h["step"] for h in out["history"]]
    assert steps.count(12) == 2          # re-executed after restore
    assert out["final_step"] == 25
    # the re-run of step 12 saw the same tokens and the restored state:
    # the same loss as the first run of it
    first, again = [h["loss"] for h in out["history"] if h["step"] == 12]
    assert first == again


def test_trainer_async_checkpoint_snapshots_at_save(small_cfg, tmp_path):
    """``checkpoint_async``: the state copied to host before ``save``
    returns, though the step after it updates the tensors in place."""
    tcfg = TrainerConfig(n_steps=25, seq_len=16, global_batch=4,
                         checkpoint_every=10, checkpoint_async=True,
                         checkpoint_dir=str(tmp_path), log_every=1000)
    inj = FailureInjector(fail_at_steps={17})
    out = Trainer(small_cfg, tcfg, injector=inj, log_fn=lambda s: None,
                  device="cpu").run()
    first, again = [h["loss"] for h in out["history"] if h["step"] == 12]
    assert first == again


def test_trainer_failure_without_checkpoint_restarts_fresh(small_cfg,
                                                           tmp_path):
    tcfg = TrainerConfig(n_steps=8, seq_len=16, global_batch=4,
                         checkpoint_every=100, checkpoint_dir=str(tmp_path),
                         log_every=1000)
    inj = FailureInjector(fail_at_steps={3})
    out = Trainer(small_cfg, tcfg, injector=inj, log_fn=lambda s: None,
                  device="cpu").run()
    assert out["restarts"] == 1 and out["final_step"] == 8


def test_compressed_training_converges(small_cfg, tmp_path):
    tcfg = TrainerConfig(n_steps=25, seq_len=32, global_batch=4,
                         compress_grads=True, checkpoint_every=1000,
                         checkpoint_dir=str(tmp_path), log_every=1000)
    out = Trainer(small_cfg, tcfg, log_fn=lambda s: None, device="cpu").run()
    losses = [h["loss"] for h in out["history"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_trainer_lands_on_cuda_unless_asked(small_cfg, monkeypatch,
                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(small_cfg, TrainerConfig(checkpoint_dir=str(tmp_path)))
