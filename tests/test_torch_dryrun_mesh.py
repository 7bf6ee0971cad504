"""The dry run's per-chip count on a (2, 2) mesh held to the JAX
package's per-partition program, on the CPU.

JAX's partitioner emits one partition's program; the port traces one
chip's program (``repro_torch.launch.dryrun.chip_program``).  A
subprocess with 4 CPU devices lowers JAX's unrolled train step of the
qwen3_4b and olmoe_1b_7b smoke configs (float32, B = 2, S = 64, remat)
on a (2, 2) mesh with Auto axes (ROADMAP C3) and reports its memory,
its ``dot`` FLOPs and its collectives (the JAX dry run's
``collective_bytes``, with the operations each kind comes from).

- ``argument_bytes`` and ``alias_bytes`` equal JAX's exactly, and
  ``output_bytes`` less the output tuple's 8-byte entries.
- The products per chip plus the attention term (JAX's einsums over the
  whole square, at the chip's heads and batch) are within
  ``PRODUCT_TOL`` of JAX's dots per partition: GSPMD lays the smoke
  step out as it sees fit and runs some of qwen3's products replicated
  over the ``model`` axis (4% of its dots), where the port's program
  shards every product the specs shard.
- Every collective kind that JAX's HLO shows the port counts too, but
  for GSPMD's re-layouts of activations and indices, which the port's
  program does not make: a ``collective-permute`` and a dense model's
  ``all-to-all``, from the embedding's gather and scatter-add and from
  elementwise operations; each is named in ``RELAYOUTS``, and the test
  checks that JAX's instructions of that kind come only from those
  operations.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as tshp
from repro_torch.launch.mesh import make_test_mesh

HERE = pathlib.Path(__file__).resolve().parent
ARCHS = ("qwen3_4b", "olmoe_1b_7b")
B, S = 2, 64
PRODUCT_TOL = 0.05
#: GSPMD's re-layouts: the kinds the port's program has no counterpart
#: of, and the operations (the last part of an instruction's op_name)
#: they may come from: the embedding's gather and its backward's
#: scatter-add, elementwise products and sums (no product of two
#: matrices and no explicit collective of the model's code)
RELAYOUT_OPS = ("gather", "scatter-add", "mul", "add_any")
RELAYOUTS = {"collective-permute": RELAYOUT_OPS,
             "all-to-all": RELAYOUT_OPS}

SCRIPT = r"""
import os, sys, json, re, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
sys.path.insert(0, sys.argv[1])
from test_torch_dryrun import hlo_dot_flops
from repro import configs
from repro.launch import shapes as shp
from repro.launch.dryrun import collective_bytes
from repro.models import registry
from repro.optim import opt_state_specs
from repro.parallel import ctx as pctx, sharding as shd
from repro.train.step import build_train_step, train_state_shardings
KIND = re.compile(r"(all-gather|all-reduce|reduce-scatter|all-to-all|"
                  r"collective-permute)(?:-start)?\(.*?op_name=\"([^\"]*)\"")
out = {}
B, S = int(sys.argv[2]), int(sys.argv[3])
for arch in sys.argv[4].split(","):
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=jnp.float32,
                              scan_layers=False, remat=True)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ispecs = shp.input_specs(cfg, shp.ShapeSpec("t", "train", S, B))
    with pctx.use_mesh(mesh), pctx.use_unroll(True):
        step = build_train_step(cfg, n_microbatch=1)
        p_sh, o_sh = train_state_shardings(cfg, mesh)
        p_specs = registry.param_specs(cfg)
        b_sh = {k: shd.batch_sharding(mesh, len(v.shape))
                for k, v in ispecs.items()}
        fn = jax.jit(step, in_shardings=(p_sh, o_sh, NamedSharding(mesh, P()),
                                         b_sh),
                     out_shardings=(p_sh, o_sh, None), donate_argnums=(0, 1))
        args = (p_specs, opt_state_specs(p_specs),
                jax.ShapeDtypeStruct((), jnp.int32), ispecs)
        compiled = fn.lower(*args).compile()
        n_out = len(jax.tree.leaves(jax.eval_shape(step, *args)))
    hlo = compiled.as_text()
    mem = compiled.memory_analysis()
    ops = {}
    for m in KIND.finditer(hlo):
        ops.setdefault(m.group(1), set()).add(m.group(2).split("/")[-1])
    out[arch] = {"args": mem.argument_size_in_bytes,
                 "out": mem.output_size_in_bytes,
                 "alias": mem.alias_size_in_bytes, "n_out": n_out,
                 "dots": hlo_dot_flops(hlo), "coll": collective_bytes(hlo),
                 "ops": {k: sorted(v) for k, v in ops.items()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_2x2():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src"), os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(HERE), str(B),
                          str(S), ",".join(ARCHS)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_per_chip_count_beside_jax(arch, jax_2x2):
    sys.path.insert(0, str(HERE))
    from test_torch_dryrun import attention_dots
    want = jax_2x2[arch]
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=torch.float32,
                              scan_layers=False, remat=True)
    mesh = make_test_mesh(2, 2)
    rec = dryrun.count_cell(cfg, tshp.ShapeSpec("t", "train", S, B), mesh,
                            n_microbatch=1)
    m = rec["memory"]
    assert m["argument_bytes"] == want["args"]
    assert m["alias_bytes"] == want["alias"]
    assert m["output_bytes"] + 8 * want["n_out"] == want["out"]
    chip = dryrun.chip_config(cfg, mesh)
    got = rec["products_per_chip"] + attention_dots(
        chip, dryrun.chip_batch(B, mesh), S, True)
    assert abs(got / want["dots"] - 1) <= PRODUCT_TOL, (got, want["dots"])
    coll = rec["collectives"]
    print(arch, "port", coll, "jax", want["coll"], want["ops"])
    for kind in dryrun.KINDS:
        if want["coll"][kind] == 0 or coll[kind] > 0:
            continue
        assert kind in RELAYOUTS, (kind, want["ops"].get(kind))
        assert set(want["ops"][kind]) <= set(RELAYOUTS[kind]), (
            kind, want["ops"][kind])
