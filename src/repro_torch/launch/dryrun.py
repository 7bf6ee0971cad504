"""The dry run of every (architecture x input shape x mesh) cell, PyTorch
port of ``repro.launch.dryrun``: per-chip memory, FLOPs, bytes and
collective bytes of one step, counted without a card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--single-pod]

Results land in ``results/dryrun/<arch>__<shape>__<mesh>.json`` with the
JAX package's keys, which ``repro_torch.core.cluster.StepCost.from_dryrun``
reads.

Where the JAX package lowers and compiles a step for 256 or 512
placeholder devices, the port traces the step on ``device="meta"`` under
:class:`repro_torch.launch.count.StepCount`: every operation runs on
tensors that have a shape and a dtype and no data, the kernels' wrappers
take their meta route (the CUDA route's allocations, no launch, the
kernel's work by its formula), and nothing is compiled.  ``lower_s`` is
the trace's seconds and ``compile_s`` is 0.

**Per chip.**  The port's mesh is logical: under a (16, 16)
``LogicalMesh`` the port computes every shard on its one device, so a
count of that run is the whole mesh's work.  The dry run instead traces
one chip's program (:func:`chip_config`, :func:`chip_program`): the step
at the per-chip shapes that the sharding specs
(``repro_torch.parallel.sharding``) give, which is how the JAX package's
partitioner emits one partition's program:

- the batch over the data axes (``pod``, ``data``) where it divides;
- over ``model``: attention heads (and kv heads where they divide; else
  the kv heads that the chip's query heads read), the feed-forward width,
  the vocabulary and the recurrent width where each divides.  The
  weights' FSDP dims (``embed``, ``expert_mlp``) are whole, as gathered
  for the compute; the xLSTM's blocks stay whole (their weights shard a
  dim that is contracted, so each chip computes them whole);
- a MoE layer runs one shard's dispatch (``parallel.ctx.use_chip``):
  ``B / dp x S / m`` tokens over all experts at their capacity, the
  rows that one chip's experts take after the all-to-all.

Replicated work (norms, the router, a kv projection that does not
divide) stays whole on every chip, so it shows, as it does in the JAX
package's per-partition counts.  The collectives are counted
(:func:`collectives`) where the specs gather or reduce a sharded leaf or
activation, with the JAX package's ring model (all-gather: result bytes;
all-reduce: 2 x bytes; reduce-scatter and all-to-all: operand bytes).

The memory keys: ``argument_bytes`` is exactly the per-chip shards of
the step's arguments under the specs (parameters, optimizer state, step
index, batch; for serving, parameters and tokens or cache);
``output_bytes`` the same of the outputs; ``alias_bytes`` the outputs
updated in place (the train state, the decode cache); ``temp_bytes`` the
peak of the per-chip program's live bytes beyond its own arguments;
``generated_code_bytes`` is 0 (nothing is compiled).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.launch import shapes as shp
from repro_torch.launch.count import StepCount
from repro_torch.launch.mesh import LogicalMesh, make_production_mesh
from repro_torch.models import registry
from repro_torch.models.common import F32, ModelConfig
from repro_torch.optim.adamw import tree_map
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as shd
from repro_torch.serve.step import (build_decode_step, build_prefill_step,
                                    cache_shardings, serve_rules)
from repro_torch.train.step import build_train_step, train_state_shardings

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun"
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_DT_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int32: 4}


def mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


# ---------------------------------------------------------------------------
# Per-chip shapes
# ---------------------------------------------------------------------------


def _split(n: int, ways: int) -> int:
    """``n`` over ``ways`` shards where it divides, else ``n`` whole."""
    return n // ways if ways > 1 and n % ways == 0 else n


def chip_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """The config of one chip's program under ``mesh`` (see the module
    docstring): the widths that the ``model`` axis shards, divided."""
    tp = mesh.shape.get("model", 1)
    if tp == 1:
        return cfg
    over = {"head_dim": cfg.hd, "vocab": _split(cfg.vocab, tp)}
    if cfg.family != "xlstm":
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        if cfg.tp_attention:
            h_loc = -(-h // tp)             # padded heads, one kv each
            hkv_loc = h_loc
        elif h % tp == 0:
            h_loc = h // tp
            hkv_loc = (hkv // tp if hkv % tp == 0
                       else max(1, h_loc // cfg.q_per_kv))
        else:
            h_loc, hkv_loc = h, hkv
        over.update(n_heads=h_loc, n_kv_heads=hkv_loc, tp_attention=False)
        if cfg.n_experts == 0:
            over["d_ff"] = _split(cfg.d_ff, tp)
        if cfg.lru_width:
            over["lru_width"] = _split(cfg.lru_width, tp)
    return dataclasses.replace(cfg, **over)


def _chip_specs(ccfg: ModelConfig, mesh) -> dict:
    """The parameter shapes of one chip's program: ``ccfg``'s, a MoE's
    expert weights cut to the chip's E / m experts where they divide."""
    specs = registry.param_specs(ccfg)
    tp = mesh.shape.get("model", 1)
    if ccfg.n_experts and tp > 1 and ccfg.n_experts % tp == 0:
        experts = specs["layers"]["moe"]
        for k in ("w_gate", "w_up", "w_down"):
            n, e, *rest = experts[k]
            experts[k] = type(experts[k])((n, e // tp, *rest))
    return specs


def chip_batch(batch: int, mesh) -> int:
    return _split(batch, pctx.dp_size(mesh))


def _chip_mesh(mesh) -> LogicalMesh:
    """The mesh one chip's program runs under: its own data shard, the
    ``model`` axis kept (a MoE layer's sequence shards)."""
    return LogicalMesh(("data", "model"), (1, mesh.shape.get("model", 1)))


# ---------------------------------------------------------------------------
# Meta tensors and shard bytes
# ---------------------------------------------------------------------------


def _leaf_dtype(shape, dtype):
    return torch.float32 if isinstance(shape, F32) else dtype


def meta_tree(specs, dtype):
    """Meta tensors at a spec tree's shapes (``F32`` leaves float32)."""
    if isinstance(specs, dict):
        return {k: meta_tree(v, dtype) for k, v in specs.items()}
    return torch.empty(tuple(specs), dtype=_leaf_dtype(specs, dtype),
                       device="meta")


def _shard_bytes(shape, dtype, spec, mesh) -> int:
    return shd.size_of_spec(spec, tuple(shape), mesh) * _DT_BYTES[dtype]


def _tree_shard_bytes(specs, shardings, dtype, mesh) -> int:
    """Per-chip bytes of a spec tree under a tree of shardings."""
    if isinstance(specs, dict):
        return sum(_tree_shard_bytes(specs[k], shardings[k], dtype, mesh)
                   for k in specs)
    if not specs:                        # an int32 scalar ("len")
        return 4
    return _shard_bytes(specs, _leaf_dtype(specs, dtype), shardings.spec,
                        mesh)


def _param_bytes(cfg, mesh, p_sh) -> int:
    return _tree_shard_bytes(registry.param_specs(cfg), p_sh, cfg.dtype,
                             mesh)


def _opt_bytes(cfg, mesh, p_sh) -> int:
    """m and v in float32 at the parameters' shards, the int32 count."""
    specs = tree_map(lambda s: F32(s), registry.param_specs(cfg))
    return 2 * _tree_shard_bytes(specs, p_sh, cfg.dtype, mesh) + 4


def _batch_bytes(ispecs: dict, mesh) -> int:
    """Per-chip bytes of the batch's leaves (a decode cell's cache
    apart)."""
    total = 0
    for k, (shape, dtype) in ispecs.items():
        if k == "cache":
            continue
        spec = shd.batch_spec(mesh, len(shape))
        total += _shard_bytes(shape, dtype, spec, mesh)
    return total


# ---------------------------------------------------------------------------
# One chip's program on meta tensors
# ---------------------------------------------------------------------------


def chip_program(cfg: ModelConfig, shape: shp.ShapeSpec, mesh,
                 n_microbatch: int = 1) -> StepCount:
    """Trace one chip's step of ``cfg`` at ``shape`` under ``mesh`` on
    meta tensors; returns the count (``track``ed arguments included in
    the live bytes, ``args_bytes`` set on it)."""
    ccfg = chip_config(cfg, mesh)
    b = chip_batch(shape.batch, mesh)
    s = shape.seq
    meta = {"device": "meta"}
    params = meta_tree(_chip_specs(ccfg, mesh), ccfg.dtype)
    with pctx.use_mesh(_chip_mesh(mesh)), pctx.use_chip():
        if shape.kind == "train":
            opt = {"m": tree_map(lambda p: torch.empty(
                       p.shape, dtype=torch.float32, **meta), params),
                   "v": tree_map(lambda p: torch.empty(
                       p.shape, dtype=torch.float32, **meta), params),
                   "count": torch.zeros((), dtype=torch.int32, **meta)}
            batch = {"tokens": torch.zeros((b, s), dtype=torch.int32, **meta),
                     "labels": torch.zeros((b, s), dtype=torch.int32, **meta)}
            nf = shp.frontend_tokens(ccfg, s)
            if nf:
                batch["frontend_embeds"] = torch.empty(
                    (b, nf, ccfg.frontend_dim), dtype=torch.float32, **meta)
            step_idx = torch.zeros((), dtype=torch.int32, **meta)
            n_mb = n_microbatch if b % n_microbatch == 0 else 1
            step = build_train_step(ccfg, n_microbatch=n_mb)
            with StepCount() as c:
                c.args_bytes = c.track(params, opt, batch, step_idx)
                out = step(params, opt, step_idx, batch)
                del out
        elif shape.kind == "prefill":
            tokens = torch.zeros((b, s), dtype=torch.int32, **meta)
            nf = shp.frontend_tokens(ccfg, s)
            fe = (torch.empty((b, nf, ccfg.frontend_dim),
                              dtype=torch.float32, **meta) if nf else None)
            step = build_prefill_step(ccfg)
            with StepCount() as c, torch.no_grad():
                c.args_bytes = c.track(params, tokens, fe)
                out = step(params, tokens, fe)
                del out
        else:
            cache = meta_tree(registry.cache_specs(ccfg, b, s), ccfg.dtype)
            cache["len"] = s - 1                 # the last position free
            token = torch.zeros((b,), dtype=torch.int32, **meta)
            step = build_decode_step(ccfg)
            with StepCount() as c, torch.no_grad():
                c.args_bytes = c.track(params, token, cache)
                out = step(params, token, cache)
                del out
    return c


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _data_ways(spec, mesh) -> int:
    """The batch axes' ways over which a spec shards its leaf."""
    ways = 1
    for entry in spec:
        for a in shd._axes(entry):
            if a in ("pod", "data"):
                ways *= mesh.shape[a]
    return ways


def _n_blocks(cfg: ModelConfig) -> int:
    """Residual blocks of a layer stack that end in a row-parallel
    product (attention or mixer, then the feed-forward), all layers."""
    n = cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec" else 0)
    return 2 * n + (cfg.n_layers if cfg.family == "encdec" else 0)


def collectives(cfg: ModelConfig, shape: shp.ShapeSpec, mesh,
                n_microbatch: int = 1) -> dict:
    """Per-chip wire bytes by collective kind for one step, counted where
    the specs gather or reduce (ring model as the JAX package's
    ``collective_bytes``):

    - all-gather: each parameter leaf sharded over a data axis (FSDP) is
      gathered for the forward, again for the backward and for the
      remat's recomputation, per microbatch (once a step under
      ``gather_weights_once``); result bytes;
    - reduce-scatter: each such leaf's gradient, per microbatch;
    - all-reduce: each gradient shard over the data axes that do not
      shard its leaf (``pod``, or all of them), per microbatch; over
      ``model``, the residual stream after each
      row-parallel block (forward, remat, backward), the vocabulary's
      softmax sums, and a decode step's split attention partials;
    - all-to-all: a MoE layer's dispatch and combine, each pass.
    """
    out = {k: 0 for k in KINDS}
    out["count"] = 0

    def add(kind, n_bytes, times=1):
        if n_bytes > 0 and times > 0:
            out[kind] += int(n_bytes * (2 if kind == "all-reduce" else 1)
                             * times)
            out["count"] += int(times)

    tp = mesh.shape.get("model", 1)
    dp = pctx.dp_size(mesh)
    b = chip_batch(shape.batch, mesh)
    s = shape.seq if shape.kind != "decode" else 1
    elt = _DT_BYTES[cfg.dtype]
    train = shape.kind == "train"
    if train:
        p_sh, _ = train_state_shardings(cfg, mesh)
    else:
        rules = serve_rules(cfg, mesh, shape.batch)
        p_sh = shd.shardings_from_axes(registry.logical_axes(cfg), mesh,
                                       rules, registry.param_specs(cfg))
    passes = (3 if cfg.remat else 2) if train else 1
    mbs = n_microbatch if train else 1
    gathers = 1 if (cfg.gather_weights_once and train) else passes * mbs
    specs = registry.param_specs(cfg)

    def walk(sp, sh):
        if isinstance(sp, dict):
            for k in sp:
                walk(sp[k], sh[k])
            return
        dt = _leaf_dtype(sp, cfg.dtype)
        shard = _shard_bytes(sp, dt, sh.spec, mesh)
        ways = _data_ways(sh.spec, mesh)
        if ways > 1:
            add("all-gather", shard * ways, gathers)
            if train:
                add("reduce-scatter", shard * ways, mbs)
        if train and dp > ways:         # the data axes it is whole over
            add("all-reduce", shard, mbs)
    walk(specs, p_sh)
    if tp > 1:
        act = b * s * cfg.d_model * elt
        add("all-reduce", act, _n_blocks(cfg) * (passes if train else 1)
            * mbs)
        if cfg.vocab % tp == 0:                 # max and sum of exp
            add("all-reduce", 2 * b * s * 4, passes - 1 if train else 1)
        if cfg.n_experts:
            t_loc = b * (s // tp if s % tp == 0 and s >= tp else s)
            from repro_torch.models.moe import capacity
            buf = cfg.n_experts * capacity(max(t_loc, 1), cfg) \
                * cfg.d_model * elt
            n_moe = cfg.n_layers
            add("all-to-all", buf, 2 * n_moe * (passes if train else 1)
                * mbs)
        if shape.kind == "decode" and cfg.family in ("dense", "moe", "vlm",
                                                     "encdec"):
            # the cache's sequence shards: (max, sum, output) partials
            part = b * cfg.n_heads * (cfg.hd + 2) * 4
            n_attn = cfg.n_layers * (2 if cfg.family == "encdec" else 1)
            add("all-reduce", part, n_attn)
    return out


# ---------------------------------------------------------------------------
# A cell
# ---------------------------------------------------------------------------


def _memory(cfg, shape, mesh, c: StepCount) -> dict:
    """The JAX package's memory keys for this cell (module docstring)."""
    ispecs = shp.input_specs(cfg, shape)
    if shape.kind == "train":
        p_sh, _ = train_state_shardings(cfg, mesh)
        state = _param_bytes(cfg, mesh, p_sh) + _opt_bytes(cfg, mesh, p_sh)
        args = state + 4 + _batch_bytes(ispecs, mesh)
        outs = state + 3 * 4                     # + loss, grad_norm, lr
        alias = state
    else:
        rules = serve_rules(cfg, mesh, shape.batch)
        p_sh = shd.shardings_from_axes(registry.logical_axes(cfg), mesh,
                                       rules, registry.param_specs(cfg))
        max_len = shape.seq + 64 if shape.kind == "prefill" else shape.seq
        c_sh = cache_shardings(cfg, mesh, shape.batch, max_len, rules)
        cache = _tree_shard_bytes(registry.cache_specs(cfg, shape.batch,
                                                       max_len),
                                  c_sh, cfg.dtype, mesh)
        logits = _shard_bytes((shape.batch, cfg.vocab), torch.float32,
                              shd.spec_from_axes(("batch", "vocab"), mesh,
                                                 rules,
                                                 (shape.batch, cfg.vocab)),
                              mesh)
        params = _param_bytes(cfg, mesh, p_sh)
        if shape.kind == "prefill":
            args = params + _batch_bytes(ispecs, mesh)
            alias = 0
        else:
            tok = _shard_bytes((shape.batch,), torch.int32,
                               shd.spec_from_axes(("batch",), mesh, rules,
                                                  (shape.batch,)), mesh)
            args = params + tok + cache
            alias = cache
        outs = logits + cache
    return {"argument_bytes": int(args), "output_bytes": int(outs),
            "temp_bytes": int(max(c.peak - c.args_bytes, 0)),
            "alias_bytes": int(alias), "generated_code_bytes": 0}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: Optional[dict] = None, mesh=None) -> dict:
    """Count one (arch, shape, mesh) cell; returns its record.  ``mesh``
    (any ``LogicalMesh``) replaces the production mesh, for tests."""
    cfg = configs.get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shp.SHAPES[shape_name]
    tag = mesh_tag(multi_pod)
    skip = shp.applicable(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": tag,
                "status": "n/a", "reason": skip}
    return count_cell(cfg, shape, mesh or make_production_mesh(
        multi_pod=multi_pod), arch=arch, tag=tag)


def count_cell(cfg: ModelConfig, shape: shp.ShapeSpec, mesh, *,
               arch: str = "", tag: str = "",
               n_microbatch: Optional[int] = None) -> dict:
    """The record of ``cfg`` at ``shape`` on ``mesh`` (any config and
    shape: the tests and ``chip_smoke.py`` count cut configs with it);
    a train step takes ``n_microbatch`` microbatches, by default
    ``MICROBATCH[arch]``."""
    n_mb = n_microbatch or (shp.MICROBATCH.get(arch, 1)
                            if shape.kind == "train" else 1)
    t0 = time.time()
    c = chip_program(cfg, shape, mesh, n_mb)
    lower_s = time.time() - t0
    coll = collectives(cfg, shape, mesh, n_mb)
    return {
        "arch": arch or cfg.name, "shape": shape.name,
        "mesh": tag or "x".join(map(str, mesh.sizes)),
        "status": "ok",
        "n_chips": int(mesh.devices.size),
        "lower_s": round(lower_s, 2),
        "compile_s": 0.0,
        "flops_per_chip": float(c.flops),
        "bytes_per_chip": float(c.total_bytes),
        "collectives": coll,
        "memory": _memory(cfg, shape, mesh, c),
        "n_params": cfg.n_params(),
        "products_per_chip": int(c.products),
        "peak_bytes": int(c.peak),
        "kernels": c.kernels.by_source,
        "n_microbatch": n_mb,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose=True):
    tag = mesh_tag(multi_pod)
    try:
        res = lower_cell(arch, shape_name, multi_pod)
    except Exception as e:  # noqa: BLE001 — record failures as data
        res = {"arch": arch, "shape": shape_name, "mesh": tag,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    RESULTS.mkdir(parents=True, exist_ok=True)
    out = RESULTS / f"{arch}__{shape_name}__{tag}.json"
    out.write_text(json.dumps(res, indent=2))
    if verbose:
        if res["status"] == "ok":
            print(f"[ok] {arch} x {shape_name} x {tag}: "
                  f"flops/chip={res['flops_per_chip']:.3e} "
                  f"bytes/chip={res['bytes_per_chip']:.3e} "
                  f"coll={res['collectives']['count']} "
                  f"trace={res['lower_s']:.1f}s")
        else:
            print(f"[{res['status']}] {arch} x {shape_name} x {tag}: "
                  f"{res.get('reason', res.get('error', ''))}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    meshes = []
    if args.multi_pod or not args.single_pod:
        meshes.append(True)
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    meshes = sorted(set(meshes))  # [False, True] or subset

    archs = configs.ARCHS if (args.all or not args.arch) else [args.arch]
    shape_names = (list(shp.SHAPES) if (args.all or not args.shape)
                   else [args.shape])

    failures = 0
    for arch in archs:
        for shape_name in shape_names:
            for mp in meshes:
                out = RESULTS / f"{arch}__{shape_name}__{mesh_tag(mp)}.json"
                if args.skip_existing and out.exists():
                    prev = json.loads(out.read_text())
                    if prev.get("status") in ("ok", "n/a"):
                        continue
                res = run_cell(arch, shape_name, mp)
                if res["status"] == "error":
                    failures += 1
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
