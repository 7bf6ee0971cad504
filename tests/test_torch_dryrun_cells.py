"""The dry run at full width on the production mesh, on the CPU: every
arch's train_4k and decode_32k cell on 16x16 traced on meta tensors gives
a record with status "ok", and long_500k gives the JAX package's "n/a"
reason where the JAX package skips it (and "ok" where it runs).

xlstm_1_3b's train_4k is left to the command line (``python -m
repro_torch.launch.dryrun --all``): its sLSTM is a loop over the 4,096
steps, traced step by step, which takes minutes on meta tensors.
"""
import pytest

from repro import configs as jconfigs
from repro.launch import shapes as jshp
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun

CELLS = [(a, s) for a in tconfigs.ARCHS for s in ("train_4k", "decode_32k")
         if (a, s) != ("xlstm_1_3b", "train_4k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_full_width_cell_is_ok(arch, shape):
    rec = dryrun.lower_cell(arch, shape, False)
    assert rec["status"] == "ok", rec
    assert (rec["mesh"], rec["n_chips"]) == ("16x16", 256)
    assert rec["flops_per_chip"] > 0 and rec["bytes_per_chip"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["n_params"] == tconfigs.get(arch).n_params()
    # every cell launches a kernel but xlstm's decode (its recurrences
    # step in tensor operations there)
    launches = sum(r["launches"] for r in rec["kernels"].values())
    assert launches > 0 or (arch, shape) == ("xlstm_1_3b", "decode_32k")
    assert rec["collectives"]["count"] > 0


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_long_500k_applicability_equals_jax(arch):
    rec = dryrun.lower_cell(arch, "long_500k", False)
    reason = jshp.applicable(jconfigs.get(arch), jshp.SHAPES["long_500k"])
    if reason:
        assert (rec["status"], rec["reason"]) == ("n/a", reason)
    else:
        assert rec["status"] == "ok", rec
