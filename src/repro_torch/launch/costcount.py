"""Corrected per-chip costs for the roofline, PyTorch port of
``repro.launch.costcount``.

    PYTHONPATH=src python -m repro_torch.launch.costcount [--arch A] [--shape S] [--multi-pod] [--variant V]

Results land in ``results/costs/<arch>__<shape>__<mesh>[__<variant>].json``
with the JAX package's record (``corrected``: flops, bytes, coll_bytes,
coll_count per chip), which ``repro_torch.core.cluster.StepCost.from_dryrun``
prefers over the dry run's record.

The JAX package needs a correction because XLA's ``cost_analysis`` counts
a while loop's body once, not once per trip: it compiles small unrolled
variants at several layer counts, fits cost = base + sum_k n_k kind_k and
evaluates the fit at the production counts, then adds the sLSTM time
scan in closed form.  The port's count runs every iteration (the dry
run's trace on meta tensors, :mod:`repro_torch.launch.dryrun`: Python
loops over layers, microbatches and the sLSTM's steps), so a direct
count of the production config replaces the fit: ``design_points`` holds
that one counted point.  :func:`_slstm_analytic` is kept as a check of
the sLSTM term, not added: the port's counted recurrent products of the
loop are that term's products with every step counted, and two products
a step in the backward (``tests/test_torch_dryrun.py``: counted x 3 (S -
1) == the term's products x (4 S - 1)).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import traceback

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "costs"

#: the JAX package's named optimization variants (config overrides)
VARIANTS = {"tp_attention": {"tp_attention": True},
            "sp_decode": {"sp_decode": True},
            "gather_once": {"gather_weights_once": True},
            "dots": {"remat_policy": "dots"},
            "causal_slice": {"causal_slice": True},
            "tp_causal": {"tp_attention": True, "causal_slice": True},
            "tp_causal_dots": {"tp_attention": True, "causal_slice": True,
                               "remat_policy": "dots"},
            "gather_causal": {"gather_weights_once": True,
                              "causal_slice": True},
            "tp_causal_gather": {"tp_attention": True,
                                 "causal_slice": True,
                                 "gather_weights_once": True},
            "": None}


def _slstm_analytic(cfg, shape, mesh):
    """The JAX package's per-chip correction for the sLSTM time scan
    (counted once by XLA, runs S times): (S-1) x per-step body, per sLSTM
    layer, x 3 passes in training (forward, remat forward, backward)."""
    if cfg.family != "xlstm":
        return {}
    from repro_torch.models.xlstm import _block_ids
    from repro_torch.parallel import ctx as pctx

    _, s_ids = _block_ids(cfg)
    n_slstm = len(s_ids)
    if n_slstm == 0:
        return {}
    if shape.kind == "decode":
        return {}                       # S == 1 at decode
    seq = shape.seq
    dp = pctx.dp_size(mesh)
    b_loc = max(shape.batch // dp, 1)
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    # per-step: 4 recurrent einsums (B,H,hd)x(H,hd,hd) + ~12 elementwise
    flops_step = b_loc * (4 * h * hd * hd * 2 + 12 * h * hd)
    bytes_step = 4 * h * hd * hd * 4 + b_loc * h * hd * 4 * 10
    mult = n_slstm * (seq - 1)
    if shape.kind == "train":
        mult *= 3                       # fwd + remat-fwd + bwd
    return {"flops": flops_step * mult, "bytes": bytes_step * mult,
            "coll_bytes": 0.0, "coll_count": 0.0}


def corrected_costs(arch: str, shape_name: str, multi_pod: bool,
                    overrides: dict | None = None) -> dict:
    from repro_torch import configs
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import shapes as shp
    from repro_torch.launch.mesh import make_production_mesh

    cfg = configs.get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shp.SHAPES[shape_name]
    mesh_tag = dr.mesh_tag(multi_pod)
    skip = shp.applicable(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                "status": "n/a", "reason": skip}
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = dr.count_cell(cfg, shape, mesh, arch=arch, tag=mesh_tag)
    coll = rec["collectives"]
    point = {"flops": rec["flops_per_chip"],
             "bytes": rec["bytes_per_chip"],
             "coll_bytes": float(sum(v for k, v in coll.items()
                                     if k != "count")),
             "coll_count": float(coll["count"])}
    out = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "status": "ok", "n_chips": int(mesh.devices.size),
           "overrides": overrides or {},
           "corrected": dict(point),
           "design_points": [dict(point, n_layers=cfg.n_layers,
                                  n_microbatch=rec["n_microbatch"])]}
    extra = _slstm_analytic(cfg, shape, mesh)
    if extra:
        out["slstm_analytic"] = extra
    return out


def run_cell(arch, shape_name, multi_pod, verbose=True, overrides=None,
             variant=""):
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    try:
        res = corrected_costs(arch, shape_name, multi_pod, overrides)
    except Exception as e:  # noqa: BLE001
        res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    RESULTS.mkdir(parents=True, exist_ok=True)
    suffix = f"__{variant}" if variant else ""
    (RESULTS / f"{arch}__{shape_name}__{mesh_tag}{suffix}.json").write_text(
        json.dumps(res, indent=2))
    if verbose:
        if res["status"] == "ok":
            c = res["corrected"]
            print(f"[ok] {arch} x {shape_name} x {mesh_tag}{suffix}: "
                  f"flops/chip={c['flops']:.3e} bytes/chip={c['bytes']:.3e}"
                  f" coll/chip={c['coll_bytes']:.3e}")
        else:
            print(f"[{res['status']}] {arch} x {shape_name} x {mesh_tag}: "
                  f"{res.get('reason', res.get('error',''))[:300]}")
    return res


def main(argv=None):
    from repro_torch import configs
    from repro_torch.launch import shapes as shp

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="",
                    help="named optimization variant, e.g. tp_attention")
    args = ap.parse_args(argv)
    overrides = VARIANTS[args.variant]
    archs = [args.arch] if args.arch else configs.ARCHS
    shapes = [args.shape] if args.shape else list(shp.SHAPES)
    fails = 0
    for a in archs:
        for s in shapes:
            tag = "2x16x16" if args.multi_pod else "16x16"
            suffix = f"__{args.variant}" if args.variant else ""
            f = RESULTS / f"{a}__{s}__{tag}{suffix}.json"
            if args.skip_existing and f.exists():
                prev = json.loads(f.read_text())
                if prev.get("status") in ("ok", "n/a"):
                    continue
            r = run_cell(a, s, args.multi_pod, overrides=overrides,
                         variant=args.variant)
            fails += r["status"] == "error"
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
