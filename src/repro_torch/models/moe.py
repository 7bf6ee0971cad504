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

``moe_ffn_sharded`` (experts over a device mesh) is mesh code and raises
(ROADMAP A12): the port's mesh is logical, over one card, so ``moe_ffn``
always takes the one-shard path.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import F32, ModelConfig

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
    """xt (T, D) -> top-k ids (T, k) int64, weights float32 (T, k) and
    the aux loss (a float32 scalar, ``None`` unless ``aux``)."""
    probs = torch.softmax(xt.float() @ router, dim=-1)          # (T, E)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :cfg.top_k], ids[:, :cfg.top_k]
    w = w / w.sum(dim=-1, keepdim=True)
    if not aux:
        return ids, w, None
    f_e = F.one_hot(ids, cfg.n_experts).sum(dim=1).float().mean(dim=0)
    p_e = probs.mean(dim=0)
    return ids, w, cfg.n_experts * (f_e * p_e).sum()


def dispatch_indices(ids: torch.Tensor, cap: int, n_experts: int):
    """Place of each (token, slot) in its expert's capacity buffer.

    Returns flat indices (T*k,) into (E*cap + 1) rows, the dropped slots
    at the spare row E*cap, and the kept mask (T*k,)."""
    flat = ids.reshape(-1)                                      # token-major
    onehot = F.one_hot(flat, n_experts)                         # (T*k, E)
    pos = onehot.cumsum(dim=0).gather(1, flat[:, None])[:, 0] - 1
    keep = pos < cap
    return torch.where(keep, flat * cap + pos, n_experts * cap), keep


def expert_ffn(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """buf (E, C, D) x weights (E, D, F)/(E, F, D) -> (E, C, D)."""
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, w_down)


def local_moe(xt: torch.Tensor, p: dict, cfg: ModelConfig, cap: int, *,
              aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dispatch -> expert FFN -> combine on tokens xt (T, D)."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    ids, w, a = route(xt, p["router"], cfg, aux=aux)
    idx, _ = dispatch_indices(ids, cap, e)
    buf = xt.new_zeros((e * cap + 1, d))        # row e*cap: dropped slots
    buf.index_copy_(0, idx, xt.repeat_interleave(k, dim=0))
    out = expert_ffn(buf[:-1].view(e, cap, d), p["w_gate"], p["w_up"],
                     p["w_down"])
    # a dropped slot reads the zero row appended at e*cap
    out = torch.cat([out.reshape(e * cap, d), out.new_zeros((1, d))])
    y = (out[idx].view(t, k, d).float() * w[:, :, None]).sum(dim=1)
    return y.to(xt.dtype), a


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def moe_ffn_reference(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                      aux: bool = True):
    """x (B, S, D) -> (y (B, S, D), aux loss or ``None``)."""
    b, s, d = x.shape
    y, a = local_moe(x.reshape(b * s, d), p, cfg, capacity(b * s, cfg),
                     aux=aux)
    return y.view(b, s, d), a


def moe_ffn_sharded(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Expert parallelism over a device mesh (a ``shard_map`` with two
    ``all_to_all``s in the JAX package): mesh code, not ported."""
    raise NotImplementedError(
        "moe_ffn_sharded shards the experts over a device mesh; the port's "
        "mesh is logical, over one card (ROADMAP A12)")


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
            aux: bool = True):
    """The one-shard path: on one card there is no expert axis to shard
    over."""
    return moe_ffn_reference(cfg, p, x, aux=aux)
