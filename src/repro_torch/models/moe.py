"""Token-choice top-k Mixture-of-Experts FFN, PyTorch port of
``repro.models.moe`` (olmoe-1b-7b, moonshot-v1-16b-a3b).

One shard's capacity dispatch, the JAX package's ``moe_ffn_reference``:

* the router is a float32 parameter in a model of any dtype
  (``common.F32``) and routes in float32: softmax over the experts, the
  ``top_k`` largest in descending order with the lower expert first on
  ties (``jax.lax.top_k``'s order, by a stable descending sort: the
  order of a token's slots decides their places in the experts'
  buffers), weights renormalised over the k;
* capacity ``C = clamp(ceil(top_k * T / E * capacity_factor), 8,
  T * top_k)`` is a host int from the token count (no read of a device
  tensor); each (token, slot) takes the next place in its expert's
  buffer in token-major order, and a slot past ``C`` is dropped: it
  writes a spare row that no expert reads and contributes 0, so its
  token's residual passes through unchanged (GShard);
* each expert is a SwiGLU over its (C, D) buffer, as batched matmuls
  (``torch.bmm``): the JAX package computes these products as einsums
  outside any kernel, and no Pallas kernel lies on this path;
* the load-balancing loss is ``E * sum_e f_e p_e`` (Switch).

Expert parallelism, the JAX package's ``moe_ffn_sharded``, which
``moe_ffn`` takes whenever a mesh is active: on the port's one card the
mesh is logical, and the shards are computed side by side.  Each shard
routes and dispatches its own tokens at its own capacity, so a model on
a (2, 2) mesh drops other slots than on one chip; the ``all_to_all``
round trip over ``model`` becomes one expert ``bmm`` over every shard's
slots.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import F32, ModelConfig
from repro_torch.parallel import ctx as pctx

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def moe_specs(cfg: ModelConfig) -> dict:
    """One layer's shapes; the router is float32 in a model of any
    dtype."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    return {
        "router": F32((d, e)),
        "w_gate": (e, d, f),
        "w_up": (e, d, f),
        "w_down": (e, f, d),
    }


MOE_AXES = {
    "router": (None, None),
    "w_gate": ("expert", None, "expert_mlp"),
    "w_up": ("expert", None, "expert_mlp"),
    "w_down": ("expert", "expert_mlp", None),
}


def moe_params(generator: torch.Generator, cfg: ModelConfig, n: int, *,
               device) -> dict:
    """``n`` layers' expert parameters, stacked on a leading dimension,
    with the JAX package's scales: N(0, 1/fan_in) over each matrix's
    input dimension."""
    d, e, f, dt = cfg.d_model, cfg.n_experts, cfg.d_ff, cfg.dtype

    def dense(shape, dtype=dt, in_axis=2):
        return cm.dense_init(generator, (n,) + shape, dtype, in_axis,
                             device=device)

    return {
        "router": dense((d, e), torch.float32, in_axis=1),
        "w_gate": dense((e, d, f)),
        "w_up": dense((e, d, f)),
        "w_down": dense((e, f, d)),
    }


# ---------------------------------------------------------------------------
# Dispatch core
# ---------------------------------------------------------------------------


def capacity(t: int, cfg: ModelConfig) -> int:
    """Places per expert for ``t`` tokens (the reference's ``_capacity``)."""
    c = math.ceil(cfg.top_k * t / cfg.n_experts * cfg.capacity_factor)
    return max(8, min(c, t * cfg.top_k))


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, *,
          aux: bool = True):
    """xt (..., T, D) -> top-k ids (..., T, k) int64, weights float32
    (..., T, k) and the aux loss over each T tokens (float32 of shape
    ``...``, ``None`` unless ``aux``)."""
    probs = torch.softmax(xt.float() @ router, dim=-1)          # (..., T, E)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[..., :cfg.top_k], ids[..., :cfg.top_k]
    w = w / w.sum(dim=-1, keepdim=True)
    if not aux:
        return ids, w, None
    f_e = F.one_hot(ids, cfg.n_experts).sum(dim=-2).float().mean(dim=-2)
    p_e = probs.mean(dim=-2)
    return ids, w, cfg.n_experts * (f_e * p_e).sum(dim=-1)


def dispatch_indices(ids: torch.Tensor, cap: int, n_experts: int):
    """Place of each (token, slot) in its expert's capacity buffer, over
    each (T, k) of ids (..., T, k).

    Returns flat indices (..., T*k) into (E*cap + 1) rows, the dropped
    slots at the spare row E*cap, and the kept mask (..., T*k)."""
    flat = ids.flatten(-2)                                      # token-major
    onehot = F.one_hot(flat, n_experts)                         # (..., T*k, E)
    pos = onehot.cumsum(dim=-2).gather(-1, flat[..., None])[..., 0] - 1
    keep = pos < cap
    return torch.where(keep, flat * cap + pos, n_experts * cap), keep


def expert_ffn(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """buf (E, C, D) x weights (E, D, F)/(E, F, D) -> (E, C, D)."""
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, w_down)


def local_moe(xs: torch.Tensor, p: dict, cfg: ModelConfig, cap: int, *,
              aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dispatch -> expert FFN -> combine on each of ``n`` shards' tokens
    xs (n, T, D), each shard at capacity ``cap`` -> (y (n, T, D), the
    mean of the shards' aux losses or ``None``).  Each shard has its own
    E*cap + 1 rows, its spare row (the dropped slots) last; the experts
    run once over every shard's slots, (E, n*cap, D), as the expert
    parallelism's ``all_to_all`` round trip lays them out.  With one
    shard every reshape is a view, and the device operations are those of
    a dispatch on (T, D) with no shard axis."""
    n, t, d = xs.shape
    e, k = cfg.n_experts, cfg.top_k
    ids, w, a = route(xs, p["router"], cfg, aux=aux)
    idx, _ = dispatch_indices(ids, cap, e)                      # (n, T*k)
    rows = e * cap + 1
    if n > 1:                       # shard i's rows start at i * rows
        idx = idx + rows * torch.arange(n, device=xs.device)[:, None]
    flat = idx.reshape(-1)
    buf = xs.new_zeros((n * rows, d))
    buf.index_copy_(0, flat, xs.repeat_interleave(k, dim=1).view(-1, d))
    buf = buf.view(n, rows, d)[:, :-1].reshape(n, e, cap, d)
    xe = buf.transpose(0, 1).reshape(e, n * cap, d)
    e_w = p["w_gate"].shape[0]
    if e_w != e:
        # under parallel.ctx.use_chip only: weights of E / m experts, one
        # chip's expert shard (the dry run's program), which after the
        # all-to-all takes the slots of m shards for each of its experts;
        # this shard's rows stand for them
        if not pctx.get_chip() or e % e_w:
            raise ValueError(f"local_moe: weights of {e_w} experts for a "
                             f"config of {e}")
        xe = xe.reshape(e_w, -1, d)
    out = expert_ffn(xe, p["w_gate"], p["w_up"], p["w_down"])
    out = out.reshape(e, n, cap, d).transpose(0, 1).reshape(n, e * cap, d)
    # a dropped slot reads its shard's zero row appended at e*cap
    out = torch.cat([out, out.new_zeros((n, 1, d))], dim=1).view(-1, d)
    y = (out[flat].view(n, t, k, d).float() * w[..., None]).sum(dim=2)
    if a is not None:
        a = a.mean() if n > 1 else a[0]
    return y.to(xs.dtype), a


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def moe_ffn_reference(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                      aux: bool = True):
    """x (B, S, D) -> (y (B, S, D), aux loss or ``None``)."""
    b, s, d = x.shape
    y, a = local_moe(x.reshape(1, b * s, d), p, cfg, capacity(b * s, cfg),
                     aux=aux)
    return y.view(b, s, d), a


def moe_ffn_sharded(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                    aux: bool = True):
    """Expert parallelism over the active (logical) mesh, the JAX
    package's ``shard_map``: x (B, S, D) global -> (y, aux or ``None``).

    ``dp`` is the product of the batch axes' sizes (``("pod",
    "data")``), ``m`` the ``model`` axis's; the sequence is sharded too
    when ``S % m == 0 and S >= m and S > 1``.  Shards are contiguous
    batch blocks of B / dp in (pod, data) order, each split into
    contiguous sequence blocks of S / m when the sequence is sharded;
    a shard's tokens go in (b, s) row-major order, the order that
    decides which of its slots drop.  Each shard routes and dispatches
    its own t_loc tokens at ``capacity(t_loc)``; aux is the mean of the
    shards' (``pmean`` over the axes that shard tokens).  ``B % dp !=
    0`` raises ``ValueError``, as ``shard_map`` would.  With one shard
    this is :func:`moe_ffn_reference` itself.  Under
    ``parallel.ctx.use_chip`` (one chip's program, the dry run's) only
    the first shard is computed, and its output stands for every
    shard's."""
    mesh = pctx.get_mesh()
    m = mesh.shape["model"]
    b, s, d = x.shape
    dp = pctx.dp_size(mesh)
    if b % dp:
        raise ValueError(f"moe_ffn_sharded: a batch of {b} does not split "
                         f"over {dp} data-parallel shards ({mesh.shape})")
    ms = m if (s % m == 0 and s >= m and s > 1) else 1
    if dp * ms == 1:
        return moe_ffn_reference(cfg, p, x, aux=aux)
    bl, sl = b // dp, s // ms
    xs = x.reshape(dp, bl, ms, sl, d).transpose(1, 2).reshape(
        dp * ms, bl * sl, d)
    if pctx.get_chip():
        # one chip's program: its own shard, standing for every shard
        # (the all-gather of the outputs); the dry run counts it
        y, a = local_moe(xs[:1], p, cfg, capacity(max(bl * sl, 1), cfg),
                         aux=aux)
        y = y.expand(dp * ms, bl * sl, d)
        return y.reshape(dp, ms, bl, sl, d).transpose(1, 2).reshape(
            b, s, d), a
    y, a = local_moe(xs, p, cfg, capacity(max(bl * sl, 1), cfg), aux=aux)
    return y.view(dp, ms, bl, sl, d).transpose(1, 2).reshape(b, s, d), a


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
            aux: bool = True):
    """The expert-parallel path when a mesh is active, else the
    one-shard reference (the JAX package's dispatch)."""
    if pctx.get_mesh() is not None:
        return moe_ffn_sharded(cfg, p, x, aux=aux)
    return moe_ffn_reference(cfg, p, x, aux=aux)
