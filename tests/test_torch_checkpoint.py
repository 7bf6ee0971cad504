"""The port's checkpoints against the JAX package's, on the CPU.

The layout is the JAX package's byte for byte (``src/repro/checkpoint/
manager.py:3-16``): npy leaves in ``jax.tree.flatten`` order, named as
``jax.tree_util.keystr`` writes them, bf16 as raw ``uint16`` bits, the
manifest written last and committed by an atomic rename.  Restore is
positional, so the order is checked leaf by leaf and a checkpoint written
by either package restores into the other bit for bit.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.optim import adamw_init as jadamw_init
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch.models import registry as treg
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw_init as tadamw_init
from repro_torch.optim.adamw import tree_leaves


def _state(dtype: str, seed: int = 0):
    """(JAX state, port state) of the qwen3_4b smoke config: the same
    parameters, moments made non-zero from a seed."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen3_4b"), dtype=jdt)
    tcfg = dataclasses.replace(tconfigs.get_smoke("qwen3_4b"), dtype=tdt)
    jp = jreg.init(jcfg, jax.random.PRNGKey(seed))
    jo = jadamw_init(jp)
    rng = np.random.default_rng(seed)
    jo = {"m": jax.tree.map(lambda m: jnp.asarray(rng.standard_normal(
              m.shape), jnp.float32), jo["m"]),
          "v": jo["v"], "count": jnp.int32(7)}
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    to = tadamw_init(tp)
    to["m"] = params_from_jax(tcfg, jax.tree.map(np.asarray, jo["m"]),
                              device="cpu", dtype=torch.float32)
    to["count"] = torch.tensor(7, dtype=torch.int32)
    return {"params": jp, "opt": jo}, {"params": tp, "opt": to}


def _bits(x) -> np.ndarray:
    """The raw bits of a JAX array or a tensor, as numpy."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _assert_bit_equal(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a, b = _bits(a), _bits(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


def test_checkpoint_atomic_roundtrip(tmp_path):
    _, state = _state("bfloat16")
    tckpt.save(tmp_path, state, step=5, extra={"note": "x"})
    assert tckpt.latest_step(tmp_path) == 5
    _, like = _state("bfloat16", seed=1)
    got, step, extra = tckpt.restore(tmp_path, like)
    assert step == 5 and extra == {"note": "x"}
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_ignores_partial_writes(tmp_path):
    tree = {"w": torch.ones(4, 4)}
    tckpt.save(tmp_path, tree, step=1)
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "leaf_00000.npy").write_bytes(b"junk")
    assert tckpt.latest_step(tmp_path) == 1
    _, step, _ = tckpt.restore(tmp_path, tree)
    assert step == 1
    assert not (tmp_path / "step_00000002.tmp").exists()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_manifest_and_files_equal_to_jax(tmp_path, dtype):
    """The same state saved by both packages: manifests equal (names,
    order, shapes, dtypes) and every file byte-identical."""
    jstate, tstate = _state(dtype)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jckpt.save(jdir, jstate, step=3, extra={"k": 1})
    tckpt.save(tdir, tstate, step=3, extra={"k": 1})
    jm = (jdir / "step_00000003" / "manifest.json").read_text()
    tm = (tdir / "step_00000003" / "manifest.json").read_text()
    assert tm == jm
    names = [rec["name"] for rec in json.loads(tm)["leaves"]]
    assert names[0] == "['opt']['count']"
    assert "['params']['layers']['wq']" in names
    for rec in json.loads(tm)["leaves"]:
        assert ((tdir / "step_00000003" / rec["file"]).read_bytes()
                == (jdir / "step_00000003" / rec["file"]).read_bytes())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, dtype):
    jstate, _ = _state(dtype)
    jckpt.save(tmp_path, jstate, step=4)
    _, like = _state(dtype, seed=1)
    got, step, _ = tckpt.restore(tmp_path, like)
    assert step == 4
    _assert_bit_equal(jstate, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_into_jax(tmp_path, dtype):
    jstate, tstate = _state(dtype)
    tckpt.save(tmp_path, tstate, step=6)
    jlike, _ = _state(dtype, seed=1)
    got, step, _ = jckpt.restore(tmp_path, jlike)
    assert step == 6
    _assert_bit_equal(got, tstate)


def test_manager_async_save_copies_before_returning(tmp_path):
    """``blocking=False``: the tree is copied to host before ``save``
    returns, so an in-place update right after it does not reach the
    checkpoint."""
    mgr = tckpt.CheckpointManager(tmp_path, keep=2)
    tree = {"w": torch.zeros(64, 64), "n": torch.tensor(1)}
    mgr.save(tree, 1, blocking=False)
    tree["w"].add_(5.0)
    mgr.wait()
    got, step, _ = mgr.restore_latest({"w": torch.empty(64, 64),
                                       "n": torch.tensor(0)})
    assert step == 1 and float(got["w"].abs().max()) == 0.0
    for s in (2, 3, 4):
        mgr.save(tree, s)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000003", "step_00000004"]


def test_restore_checks_leaf_count_and_shapes(tmp_path):
    tckpt.save(tmp_path, {"a": torch.ones(2), "b": torch.ones(3)}, step=1)
    with pytest.raises(AssertionError, match="2 leaves"):
        tckpt.restore(tmp_path, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(tmp_path, {"a": torch.ones(2), "b": torch.ones(4)})
