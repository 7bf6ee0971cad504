"""The port's dry run (``repro_torch.launch.dryrun``) held to the JAX
package's lowering of the same train step on the CPU.

Each family's smoke config in float32 at B = 2, S = 64, layers unrolled,
on a (1, 1) mesh: JAX lowers and compiles ``build_train_step`` as its dry
run does (``use_unroll``, ``scan_layers=False``, Auto axes: ROADMAP C3);
the port traces its step on meta tensors under ``StepCount``.

- ``n_params``, ``argument_bytes`` and ``alias_bytes`` equal JAX's
  ``memory_analysis()`` exactly; ``output_bytes`` equal less one named
  term: XLA's output tuple carries an 8-byte index entry for each of its
  leaves.
- The products' FLOPs (``mm``/``bmm`` at 2 a multiply-add) equal the
  ``dot`` FLOPs of JAX's compiled HLO, parsed here as the JAX dry run
  parses collectives, less one named term: JAX's attention is jnp
  einsums over the whole masked square, where the port's attention is a
  kernel (its work counted apart, by visible pairs): per attention call
  2 x 2 B H Sq Sk hd for the forward, again for the remat's forward and
  twice for the backward.  xlstm_1_3b is left out of this comparison (its
  sLSTM is a JAX ``lax.scan`` that the HLO counts once;
  :func:`test_slstm_term_is_the_analytic_term` holds that term), and
  recurrentgemma_9b is compared without remat (under remat XLA drops
  recomputed products that its backward does not read, where the port's
  checkpoint recomputes them).
"""
import dataclasses
import math
import os
import re

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import shapes as jshp
from repro.models import registry as jreg
from repro.optim import opt_state_specs as jopt_specs
from repro.parallel import ctx as jctx
from repro.parallel import sharding as jshd
from repro.train import step as jtrain
from repro_torch import configs as tconfigs
from repro_torch.core import cluster
from repro_torch.kernels import decode_attention as dmod
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import mlstm_kernel as mmod
from repro_torch.kernels import ops, rglru_scan as rmod, work
from repro_torch.launch import costcount, dryrun
from repro_torch.launch import shapes as tshp
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

B, S = 2, 64
FAMILIES = ["qwen3_4b", "olmoe_1b_7b", "recurrentgemma_9b", "pixtral_12b",
            "seamless_m4t_medium", "xlstm_1_3b"]
#: (arch, remat) whose products are compared (module docstring)
PRODUCT_CASES = ([(a, False) for a in FAMILIES if a != "xlstm_1_3b"]
                 + [(a, True) for a in ("qwen3_4b", "olmoe_1b_7b",
                                        "pixtral_12b",
                                        "seamless_m4t_medium")])

_DEF = re.compile(r"%([\w.\-]+) = [a-z0-9]+\[([0-9,]*)\]")
_DOT = re.compile(r"%[\w.\-]+ = [a-z0-9]+\[([0-9,]*)\]\S* "
                  r"dot\(%([\w.\-]+), %[\w.\-]+\).*?"
                  r"lhs_contracting_dims=\{([0-9,]*)\}")


def _dims(s: str):
    return [int(d) for d in s.split(",") if d]


def hlo_dot_flops(hlo: str) -> int:
    """2 x the multiply-adds of every ``dot`` of an HLO module: each
    output element times the product of the lhs's contracting dims (the
    operands' shapes from their definitions)."""
    shapes = {m.group(1): _dims(m.group(2)) for m in _DEF.finditer(hlo)}
    total = 0
    for m in _DOT.finditer(hlo):
        out, lhs, contract = m.groups()
        k = math.prod(shapes[lhs][int(i)] for i in contract.split(",") if i)
        total += 2 * math.prod(_dims(out)) * k
    return total


_COMPILED = {}


def _jax_train(arch: str, remat: bool):
    """(config, compiled step, output leaves) of JAX's unrolled train step
    of the smoke config, float32, on a (1, 1) mesh with Auto axes."""
    key = (arch, remat)
    if key not in _COMPILED:
        cfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                  dtype=jnp.float32, scan_layers=False,
                                  remat=remat)
        mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        ispecs = jshp.input_specs(cfg, jshp.ShapeSpec("t", "train", S, B))
        with jctx.use_mesh(mesh), jctx.use_unroll(True):
            step = jtrain.build_train_step(cfg, n_microbatch=1)
            p_sh, o_sh = jtrain.train_state_shardings(cfg, mesh)
            p_specs = jreg.param_specs(cfg)
            b_sh = {k: jshd.batch_sharding(mesh, len(v.shape))
                    for k, v in ispecs.items()}
            fn = jax.jit(step, in_shardings=(p_sh, o_sh,
                                             NamedSharding(mesh, P()), b_sh),
                         out_shardings=(p_sh, o_sh, None),
                         donate_argnums=(0, 1))
            args = (p_specs, jopt_specs(p_specs),
                    jax.ShapeDtypeStruct((), jnp.int32), ispecs)
            compiled = fn.lower(*args).compile()
            n_out = len(jax.tree.leaves(jax.eval_shape(step, *args)))
        _COMPILED[key] = (cfg, compiled, n_out)
    return _COMPILED[key]


def _port(arch: str, remat: bool, mesh=None):
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=torch.float32,
                              scan_layers=False, remat=remat)
    return cfg, dryrun.count_cell(cfg, tshp.ShapeSpec("t", "train", S, B),
                                  mesh or make_test_mesh(1, 1),
                                  n_microbatch=1)


def attention_dots(cfg, b: int, s: int, remat: bool) -> int:
    """JAX's attention einsums in one train step (module docstring)."""
    from repro_torch.models import encdec, rglru
    calls = []                                   # (Sq, Sk) per layer
    if cfg.family in ("dense", "moe", "vlm"):
        calls = [(s, s)] * cfg.n_layers
    elif cfg.family == "rglru":
        calls = [(s, s)] * rglru._counts(cfg)[1]
    elif cfg.family == "encdec":
        se = encdec.enc_len(cfg, s)
        calls = ([(se, se)] * cfg.n_enc_layers
                 + [(s, s), (s, se)] * cfg.n_layers)
    passes = 1 + int(remat) + 2
    return sum(2 * 2 * b * cfg.n_heads * sq * sk * cfg.hd * passes
               for sq, sk in calls)


@pytest.mark.parametrize("arch", FAMILIES)
def test_state_bytes_equal_jax(arch):
    jcfg, compiled, n_out = _jax_train(arch, True)
    tcfg, rec = _port(arch, True)
    mem = compiled.memory_analysis()
    assert rec["n_params"] == tcfg.n_params() == jcfg.n_params()
    m = rec["memory"]
    assert m["argument_bytes"] == mem.argument_size_in_bytes
    assert m["alias_bytes"] == mem.alias_size_in_bytes
    # named term: XLA's output tuple, an 8-byte index entry a leaf
    assert m["output_bytes"] + 8 * n_out == mem.output_size_in_bytes
    assert rec["status"] == "ok" and m["temp_bytes"] > 0


@pytest.mark.parametrize("arch,remat", PRODUCT_CASES)
def test_products_equal_jax_dots(arch, remat):
    jcfg, compiled, _ = _jax_train(arch, remat)
    tcfg, rec = _port(arch, remat)
    want = hlo_dot_flops(compiled.as_text())
    assert rec["products_per_chip"] + attention_dots(tcfg, B, S, remat) \
        == want
    # the attention kernels' launches: forward (and remat) and backward
    launches = {k: v["launches"] for k, v in rec["kernels"].items()}
    n_fwd = sum(v for k, v in launches.items() if "bwd" not in k)
    n_bwd = sum(v for k, v in launches.items() if "bwd" in k)
    assert n_fwd == n_bwd * (2 if remat else 1) and n_bwd > 0


def test_slstm_term_is_the_analytic_term():
    """The port counts the sLSTM loop's recurrent products (its only
    ``bmm``) at every step: S in the forward, S in the remat's forward
    and 2 S - 1 in the backward (the gradients of r and of h_{t-1}; none
    of the zero initial state).  The JAX package's ``_slstm_analytic``
    adds S - 1 steps of one product a pass to XLA's count of one body,
    three passes.  So counted x 3 (S - 1) == analytic x (4 S - 1),
    exactly."""
    jax.devices()                        # the backend first: the module
    saved = os.environ.get("XLA_FLAGS")  # below sets XLA_FLAGS if unset
    from repro.launch import costcount as jcc
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    s = 48
    tcfg = dataclasses.replace(tconfigs.get_smoke("xlstm_1_3b"),
                               dtype=torch.float32)
    jcfg = dataclasses.replace(jconfigs.get_smoke("xlstm_1_3b"),
                               dtype=jnp.float32)
    c = dryrun.chip_program(tcfg, tshp.ShapeSpec("t", "train", s, 4),
                            make_test_mesh(1, 1))
    counted = c.products_by_op["bmm"]
    jextra = jcc._slstm_analytic(jcfg, jshp.ShapeSpec("t", "train", s, 4),
                                 AbstractMesh((1, 1), ("data", "model")))
    h, hd = jcfg.n_heads, jcfg.d_model // jcfg.n_heads
    per_step = 4 * h * hd * hd * 2
    analytic = jextra["flops"] // (per_step + 12 * h * hd) * per_step
    assert counted > 0 and counted * 3 * (s - 1) == analytic * (4 * s - 1)
    shape = tshp.ShapeSpec("t", "train", s, 4)
    mesh = make_test_mesh(1, 1)
    assert costcount._slstm_analytic(tcfg, shape, mesh) == jextra


def test_production_mesh_and_microbatch():
    m = make_production_mesh()
    assert (m.axis_names, m.sizes, m.devices.size) == (
        ("data", "model"), (16, 16), 256)
    p = make_production_mesh(multi_pod=True)
    assert (p.axis_names, p.sizes) == (("pod", "data", "model"),
                                       (2, 16, 16))
    assert tshp.MICROBATCH == jshp.MICROBATCH


def test_stepcost_reads_the_records(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path / "dryrun")
    monkeypatch.setattr(costcount, "RESULTS", tmp_path / "costs")
    monkeypatch.setattr(cluster, "RESULTS", tmp_path / "dryrun")
    rec = dryrun.run_cell("olmoe_1b_7b", "decode_32k", False, verbose=False)
    assert rec["status"] == "ok"
    cost = cluster.StepCost.from_dryrun("olmoe_1b_7b", "decode_32k")
    cm = cluster.CostModel()
    want = int(max(rec["flops_per_chip"] / cm.peak_flops,
                   rec["bytes_per_chip"] / cm.hbm_bw) * cluster.SEC)
    coll = sum(v for k, v in rec["collectives"].items() if k != "count")
    assert (cost.compute_ns, cost.ici_bytes) == (want, coll) and coll > 0
    costs = costcount.run_cell("olmoe_1b_7b", "decode_32k", False,
                               verbose=False, variant="dots",
                               overrides=costcount.VARIANTS["dots"])
    c = costs["corrected"]
    assert c["flops"] == rec["flops_per_chip"]
    dots = cluster.StepCost.from_dryrun("olmoe_1b_7b", "decode_32k",
                                        variant="dots")
    assert dots.ici_bytes == int(c["coll_bytes"])
    assert costs["design_points"][0]["flops"] == c["flops"]


@pytest.mark.parametrize("sq,sk,causal,window", [
    (1, 1, True, 0), (7, 3, True, 0), (3, 7, True, 0), (64, 64, False, 0),
    (100, 100, True, 16), (100, 40, True, 16), (5, 9, False, 2),
    (300, 300, True, 299), (30, 30, True, 31)])
def test_visible_pairs_closed_form(sq, sk, causal, window):
    loop = sum(min(sk, q + 1 if causal else sk)
               - (max(0, q - window + 1) if window > 0 else 0)
               for q in range(sq))
    assert work.visible_pairs(sq, sk, causal, window) == max(loop, 0)


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.randn(*shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def _counters():
    return (fmod.flash_attention_flat.launches,
            fmod.flash_attention_bwd.launches, dmod.decode_attention.launches,
            rmod.rglru_scan.launches, rmod.rglru_scan_bwd.launches,
            mmod.mlstm_chunkwise.launches, mmod.mlstm_chunkwise_bwd.launches)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_meta_route_allocates_and_tallies(dtype):
    """Each model-path wrapper on meta tensors: the CUDA route's outputs
    (shapes, dtypes), its source's launch and work in the tally, and no
    wrapper counter moved."""
    before = _counters()
    b, s, h, hkv, hd = 2, 80, 4, 2, 64
    with work.KernelTally() as t:
        q, k, v = (_meta(b, s, n, hd, dtype=dtype, grad=True)
                   for n in (h, hkv, hkv))
        o = ops.flash_attention(q, k, v, causal=True, window=0)
        assert (o.shape, o.dtype, o.device.type) == (q.shape, dtype, "meta")
        dq, dk, dv = torch.autograd.grad(o.float().sum(), (q, k, v))
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
        out = ops.decode_attention(_meta(b, h, hd, dtype=dtype),
                                   _meta(b, s, hkv, hd, dtype=dtype),
                                   _meta(b, s, hkv, hd, dtype=dtype),
                                   torch.zeros(b, dtype=torch.int32,
                                               device="meta"))
        assert (out.shape, out.dtype) == ((b, h, hd), dtype)
        la, bb = (_meta(b, s, 96, dtype=torch.float32, grad=True)
                  for _ in range(2))
        hs = ops.rglru(la, bb)
        assert hs.shape == la.shape
        torch.autograd.grad(hs.sum(), (la, bb))
        qm, km, vm = (_meta(b, s, 2, 32, dtype=dtype, grad=True)
                      for _ in range(3))
        ig, fg = (_meta(b, s, 2, dtype=torch.float32, grad=True)
                  for _ in range(2))
        hm, (cm_, nm) = ops.mlstm(qm, km, vm, ig, fg)
        assert (hm.shape, cm_.shape, nm.shape) == (
            qm.shape, (b, 2, 32, 32), (b, 2, 32))
        torch.autograd.grad(hm.float().sum(), (qm, km, vm, ig, fg))
    assert _counters() == before
    f32 = dtype == torch.float32
    want = {fmod.FWD_TF32X3 if f32 else fmod.FWD_SM90: 1,
            fmod.BWD_TF32X3 if f32 else fmod.BWD_SM90: 1,
            dmod.SOURCE: 1, rmod.SOURCE: 1, rmod.BWD_SOURCE: 1,
            mmod.fwd_source(dtype, 32): 1, mmod.bwd_source(dtype, 32): 1}
    assert t.launches() == dict(sorted(want.items()))
    row = t.by_source[fmod.FWD_TF32X3 if f32 else fmod.FWD_SM90]
    assert (row["bytes"], row["flops"]) == work.attn_fwd_work(
        b, h, hkv, s, s, hd, q.element_size(), True, 0)


def test_meta_route_workspaces():
    """The workspace sizes the meta route allocates, against the sources'
    layouts at a few shapes (the card's own size functions are held to
    them by ``tests/test_torch_cuda.py``)."""
    # 3 chunks x 2 rows x 3 tiles of 32: 13 flags (1 + 2 x 6), rounded to
    # 16, then 12 carries of 32 floats
    assert work.rglru_ws_bytes(2, 600, 70, 256, 32) == 4 * (16 + 12 * 32)
    assert work.rglru_bwd_ws_bytes(2, 600, 70, 256, 32) == 16 + 8 * (
        2 * 2 * 3 * 32)
    assert work.rglru_ws_bytes(1, 0, 8, 256, 32) == 0
    for src in (mmod.BWD_SM90, mmod.BWD_TF32X3, mmod.BWD_CUDA_CORES):
        n = work.mlstm_bwd_ws_bytes(src, 3, 128, 64)
        assert n > 0 and n % (256 if src != mmod.BWD_CUDA_CORES else 16) \
            == 0
        assert work.mlstm_bwd_ws_bytes(src, 3, 100, 64) == 0


def test_expert_shard_only_in_one_chips_program():
    """``local_moe`` takes a chip's E / m expert weights only under
    ``parallel.ctx.use_chip`` (the dry run's program), and only where m
    divides E; any other count of expert weights raises."""
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel import ctx as pctx
    cfg = tconfigs.get_smoke("olmoe_1b_7b")
    e = cfg.n_experts
    g = torch.Generator().manual_seed(0)
    p = {k: v[0] for k, v in tmoe.moe_params(g, cfg, 1,
                                             device="cpu").items()}
    x = torch.randn(1, 16, cfg.d_model, generator=g).to(cfg.dtype)
    cap = tmoe.capacity(16, cfg)
    half = {k: (v if k == "router" else v[: e // 2]) for k, v in p.items()}
    odd = {k: (v if k == "router" else v[: e - 1]) for k, v in p.items()}
    with pytest.raises(ValueError, match="experts"):
        tmoe.local_moe(x, half, cfg, cap)
    with pctx.use_chip():
        y, _ = tmoe.local_moe(x, half, cfg, cap)
        assert y.shape == x.shape
        with pytest.raises(ValueError, match="experts"):
            tmoe.local_moe(x, odd, cfg, cap)
    assert not pctx.get_chip()


def test_one_kernel_tally_at_a_time():
    """The meta route adds to the one active tally; a second raises."""
    with work.KernelTally() as t:
        work.record("a.cu", (10, 20))
        with pytest.raises(RuntimeError):
            with work.KernelTally():
                pass
    work.record("a.cu", (10, 20))               # no tally: nothing kept
    assert t.by_source == {"a.cu": {"launches": 1, "flops": 20,
                                    "bytes": 10}}
