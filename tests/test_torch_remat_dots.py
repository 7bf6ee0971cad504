"""The remat policy "dots" (the JAX package's
``dots_with_no_batch_dims_saveable``) on the CPU.

Under "dots" the port keeps the outputs of ``mm``/``addmm`` from the
forward (selective checkpointing) and recomputes the rest in the
backward; the values are those of the policy "nothing", which recomputes
everything: a train step's loss, ``grad_norm``, parameters and AdamW
moments within 1e-6 relative (float32; the same operations on the same
inputs), and within the train parity tolerances of JAX's
``build_train_step`` under "dots" (``tests/test_torch_train.py``: loss and
``grad_norm`` 1e-5 relative, leaves 1e-4 x max(1, scale)).  The dry run
counts fewer FLOPs for it at qwen3_4b x train_4k: the recomputed
projections are gone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.optim import adamw_init as jadamw_init
from repro.train.step import build_train_step as jbuild
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import frontend_tokens
from repro_torch.models import registry as treg
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw_init as tadamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.step import build_train_step as tbuild

FAMILIES = ["qwen3_4b", "olmoe_1b_7b", "recurrentgemma_9b", "pixtral_12b",
            "seamless_m4t_medium", "xlstm_1_3b"]
LR = dict(peak_lr=1e-3, warmup=2, total=10)
B, S = 2, 32


def _batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    nf = frontend_tokens(cfg, S)
    if nf:
        batch["frontend_embeds"] = rng.standard_normal(
            (B, nf, cfg.frontend_dim)).astype(np.float32)
    return batch


def _torch_step(cfg, params, batch):
    opt = tadamw_init(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return tbuild(cfg, lr_kwargs=LR)(params, opt, 1, tb)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


@pytest.mark.parametrize("arch", FAMILIES)
def test_dots_equals_nothing(arch):
    outs = {}
    for policy in ("nothing", "dots"):
        cfg = dataclasses.replace(tconfigs.get_smoke(arch),
                                  dtype=torch.float32, remat=True,
                                  remat_policy=policy)
        params = treg.init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        outs[policy] = _torch_step(cfg, params, _batch(cfg))
    (p0, o0, m0), (p1, o1, m1) = outs["nothing"], outs["dots"]
    for k in ("loss", "grad_norm"):
        assert _rel(m1[k], m0[k]) <= 1e-6
    for a, b in zip(tree_leaves({"p": p1, "m": o1["m"], "v": o1["v"]}),
                    tree_leaves({"p": p0, "m": o0["m"], "v": o0["v"]})):
        assert _rel(a, b) <= 1e-6


@pytest.mark.parametrize("arch", ["qwen3_4b", "olmoe_1b_7b"])
def test_dots_equals_jax(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32,
                               remat=True, remat_policy="dots")
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=torch.float32,
                               remat=True, remat_policy="dots")
    jp = jreg.init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    batch = _batch(tcfg)
    jp2, jo2, jm = jax.jit(jbuild(jcfg, lr_kwargs=LR))(
        jp, jadamw_init(jp), jnp.int32(1),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp2, to2, tm = _torch_step(tcfg, tp, batch)
    for k in ("loss", "grad_norm"):
        want = float(jm[k])
        assert abs(float(tm[k]) - want) <= 1e-5 * abs(want)
    for j, t in zip(jax.tree.leaves({"p": jp2, "m": jo2["m"], "v": jo2["v"]}),
                    tree_leaves({"p": tp2, "m": to2["m"], "v": to2["v"]})):
        j = np.asarray(j, np.float32)
        scale = max(1.0, float(np.abs(j).max()))
        assert float(np.abs(t.numpy() - j).max()) <= 1e-4 * scale


def test_dots_counts_fewer_flops_at_qwen3_train_4k():
    base = dryrun.lower_cell("qwen3_4b", "train_4k", False)
    dots = dryrun.lower_cell("qwen3_4b", "train_4k", False,
                             overrides={"remat_policy": "dots"})
    assert dots["flops_per_chip"] < base["flops_per_chip"]
    assert dots["products_per_chip"] < base["products_per_chip"]
    # the kernels are recomputed under both policies
    assert dots["kernels"] == base["kernels"]
    # the kept projections' outputs live until the backward
    assert dots["memory"]["temp_bytes"] > base["memory"]["temp_bytes"]


def test_unknown_policy_raises():
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen3_4b"),
                              dtype=torch.float32, remat_policy="everything")
    params = treg.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        _torch_step(cfg, params, _batch(cfg))
