"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427), PyTorch port of
``repro.models.rglru``: recurrentgemma-9b.

38 residual layers in the pattern (recurrent, recurrent, attention) x 12
plus 2 trailing recurrent layers.  Each layer = temporal-mixing block +
GeGLU MLP block.

* Recurrent block: LN -> two branches: main (D->W linear, causal conv(4),
  RG-LRU) and gate (D->W linear, GeLU); merged elementwise, W->D out proj.
  RG-LRU: r_t = sigma(W_a x + b_a); i_t = sigma(W_x x + b_x);
  log a_t = -c * softplus(Lambda) * r_t (c=8);
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), through the
  ``rglru_scan`` kernel (:func:`repro_torch.kernels.ops.rglru`).
* Attention block: sliding-window (2048) MQA (kv=1), RoPE, head_dim 256,
  through the ``flash_attention`` kernel in prefill and the
  ``decode_attention`` kernel in decode
  (:mod:`repro_torch.models.attention`).

Decode state: per recurrent layer h (B, W) float32 + conv tail (B, 3, W);
per attention layer a ring buffer of ``window`` KV slots, slot
``pos % window``.  The gate weights (``w_a``, ``b_a``, ``w_i``, ``b_i``,
``lam``) are float32 parameters in a model of any dtype
(``common.F32``); ``jax.nn.gelu`` is the tanh approximation, so the
port's GeLU is too.  Layers run in index order, the order of the JAX
package's grouped scans.  ``decode_step`` writes the state **in place**
into the cache tensors (the JAX version builds new arrays) and returns
a dict that shares them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.engine_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.common import F32, ModelConfig
from repro_torch.models.xlstm import causal_conv

LRU_C = 8.0


def layer_kinds(cfg: ModelConfig):
    """List of 'rec' / 'attn' per layer index."""
    return ["attn" if (i % 3) == 2 else "rec" for i in range(cfg.n_layers)]


def _counts(cfg: ModelConfig) -> Tuple[int, int]:
    kinds = layer_kinds(cfg)
    return kinds.count("rec"), kinds.count("attn")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _rec_specs(cfg: ModelConfig) -> dict:
    d, w, f = cfg.d_model, cfg.lru_width, cfg.d_ff
    return {
        "ln": (d,),
        "w_main": (d, w),
        "w_gate": (d, w),
        "conv": (4, w),
        "w_a": F32((w, w)),
        "b_a": F32((w,)),
        "w_i": F32((w, w)),
        "b_i": F32((w,)),
        "lam": F32((w,)),
        "w_out": (w, d),
        "ln2": (d,),
        "ff1": (d, 2 * f),
        "ff2": (f, d),
    }


def _attn_specs(cfg: ModelConfig) -> dict:
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    return {
        "ln": (d,),
        "wq": (d, h, hd),
        "wk": (d, hkv, hd),
        "wv": (d, hkv, hd),
        "wo": (h, hd, d),
        "ln2": (d,),
        "ff1": (d, 2 * f),
        "ff2": (f, d),
    }


_REC_AXES = {
    "ln": (None,),
    "w_main": ("embed", "lru"),
    "w_gate": ("embed", "lru"),
    "conv": (None, "lru"),
    "w_a": ("lru", None),
    "b_a": (None,),
    "w_i": ("lru", None),
    "b_i": (None,),
    "lam": (None,),
    "w_out": ("lru", "embed"),
    "ln2": (None,),
    "ff1": ("embed", "mlp"),
    "ff2": ("mlp", "embed"),
}

_ATTN_AXES = {
    "ln": (None,),
    "wq": ("embed", "heads", None),
    "wk": ("embed", "kv", None),
    "wv": ("embed", "kv", None),
    "wo": ("heads", None, "embed"),
    "ln2": (None,),
    "ff1": ("embed", "mlp"),
    "ff2": ("mlp", "embed"),
}


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree with a shape at every leaf (no alloc); float32
    leaves are ``common.F32`` shapes."""
    n_rec, n_attn = _counts(cfg)
    return {
        "embed": (cfg.vocab, cfg.d_model),
        "rec": cm.stacked(n_rec, _rec_specs(cfg)),
        "attn": cm.stacked(n_attn, _attn_specs(cfg)),
        "final_norm": (cfg.d_model,),
        "lm_head": (cfg.d_model, cfg.vocab),
    }


def logical_axes(cfg: ModelConfig) -> dict:
    return {
        "embed": ("vocab", "embed"),
        "rec": cm.stacked_axes(_REC_AXES),
        "attn": cm.stacked_axes(_ATTN_AXES),
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


def init(cfg: ModelConfig, generator: torch.Generator, *,
         device=None) -> dict:
    """Random parameters with the JAX package's scales: norms and gate
    biases 0, ``lam`` 0.7, embeddings N(0, 0.02), projections
    N(0, 1/fan_in).  ``generator`` must live on ``device`` (``None``
    means CUDA and raises without it)."""
    dev = resolve_device(device, "the model")
    dt, f32 = cfg.dtype, torch.float32
    n_rec, n_attn = _counts(cfg)
    d, w, f = cfg.d_model, cfg.lru_width, cfg.d_ff
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def dense(n, shape, dtype=dt, in_axis=1):
        return cm.dense_init(generator, (n,) + shape, dtype, in_axis,
                             device=dev)

    def full(shape, value=0.0, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    rec = {
        "ln": full((n_rec, d)),
        "w_main": dense(n_rec, (d, w)),
        "w_gate": dense(n_rec, (d, w)),
        "conv": dense(n_rec, (4, w)),
        "w_a": dense(n_rec, (w, w), f32),
        "b_a": full((n_rec, w), dtype=f32),
        "w_i": dense(n_rec, (w, w), f32),
        "b_i": full((n_rec, w), dtype=f32),
        "lam": full((n_rec, w), 0.7, f32),
        "w_out": dense(n_rec, (w, d)),
        "ln2": full((n_rec, d)),
        "ff1": dense(n_rec, (d, 2 * f)),
        "ff2": dense(n_rec, (f, d)),
    }
    att = {
        "ln": full((n_attn, d)),
        "wq": dense(n_attn, (d, h, hd)),
        "wk": dense(n_attn, (d, hkv, hd)),
        "wv": dense(n_attn, (d, hkv, hd)),
        "wo": dense(n_attn, (h, hd, d), in_axis=(1, 2)),
        "ln2": full((n_attn, d)),
        "ff1": dense(n_attn, (d, 2 * f)),
        "ff2": dense(n_attn, (f, d)),
    }
    return {
        "embed": cm.embed_init(generator, (cfg.vocab, d), dt, device=dev),
        "rec": rec,
        "attn": att,
        "final_norm": full((d,)),
        "lm_head": cm.dense_init(generator, (d, cfg.vocab), dt, device=dev),
    }


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def rglru_gates(p: dict, u: torch.Tensor):
    """u (B,S,W) conv output -> (log_a (B,S,W) float32, gated input
    (B,S,W) float32).  The gate matmuls run in float32 (TF32 stays off
    on the card)."""
    u32 = u.float()
    r = torch.sigmoid(u32 @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(u32 @ p["w_i"] + p["b_i"])
    log_a = -LRU_C * torch.logaddexp(p["lam"], torch.zeros_like(p["lam"])) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12)) * (i * u32)
    return log_a, gated


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear recurrence h_t = exp(log_a_t) h_{t-1} + b_t over axis 1:
    the ``rglru_scan`` kernel on CUDA, the sequential plain version on
    the CPU.  Both take h0 as the carry into step 0; the JAX model folds
    it into b[:, 0] and runs an associative scan, which is the same
    function in exact arithmetic (float32 sums in another order)."""
    return ops.rglru(log_a, b, h0)


def rec_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
              state: Optional[Tuple] = None):
    """Recurrent temporal block + MLP.  Returns (x_out, (h_last,
    conv_tail))."""
    h_in = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    main = h_in @ p["w_main"]
    gate = cm.gelu((h_in @ p["w_gate"]).float())
    u, conv_tail = causal_conv(main, p["conv"],
                               None if state is None else state[1])
    log_a, gated = rglru_gates(p, u)
    hs = rglru_scan(log_a, gated, None if state is None else state[0])
    y = (hs * gate).to(x.dtype)
    x = x + y @ p["w_out"]
    return cm.geglu_block(cfg, p, x), (hs[:, -1, :], conv_tail)


def _attn_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor):
    b, s, d = x.shape
    h_in = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    q = (h_in @ p["wq"].reshape(d, -1)).view(b, s, cfg.n_heads, cfg.hd)
    k = (h_in @ p["wk"].reshape(d, -1)).view(b, s, cfg.n_kv_heads, cfg.hd)
    v = (h_in @ p["wv"].reshape(d, -1)).view(b, s, cfg.n_kv_heads, cfg.hd)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_out(cfg: ModelConfig, p: dict, x: torch.Tensor,
              o: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = o.shape
    x = x + o.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, -1)
    return cm.geglu_block(cfg, p, x)


def attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor):
    """Sliding-window MQA block + MLP.  Returns (x_out, (k, v))."""
    q, k, v = _attn_qkv(cfg, p, x, positions)
    o = attn.multi_head_attention(q, k, v, causal=True, window=cfg.window)
    return _attn_out(cfg, p, x, o), (k, v)


# ---------------------------------------------------------------------------
# Forward (scoring)
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend_embeds=None, return_aux: bool = False):
    """tokens (B, S) -> logits (B, S, V) float32 [+ aux loss 0].

    Trainable: under grad, ``cfg.remat`` recomputes each layer in the
    backward (:func:`common.maybe_remat`; the JAX package remats each
    (rec, rec, attn) group, which changes no number), and the per-layer
    parameters are taken by one ``unbind`` of each stacked leaf
    (:func:`common.unstack`).  On the card both kernels carry their
    gradients: ``rglru_scan``'s backward kernel and the flash backward."""
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=x.device)
    n_rec, n_attn = _counts(cfg)
    rec = iter(cm.unstack(params["rec"], n_rec))
    att = iter(cm.unstack(params["attn"], n_attn))
    rec_layer = cm.maybe_remat(cfg, rec_block)
    attn_layer = cm.maybe_remat(cfg, attn_block)
    for kind in layer_kinds(cfg):
        if kind == "rec":
            x, _ = rec_layer(cfg, next(rec), x)
        else:
            x, _ = attn_layer(cfg, next(att), x, positions)
    logits = cm.final_logits(cfg, params, x)
    if return_aux:
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)
    return logits


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    n_rec, n_attn = _counts(cfg)
    w, win = cfg.lru_width, cfg.window
    kv = (n_attn, batch, win, cfg.n_kv_heads, cfg.hd)
    return {
        "h": F32((n_rec, batch, w)),
        "conv": (n_rec, batch, 3, w),
        "k": kv,
        "v": kv,
        "len": (),
    }


def cache_axes(cfg: ModelConfig) -> dict:
    return {
        "h": ("layer", "batch", "lru"),
        "conv": ("layer", "batch", None, "lru"),
        "k": ("layer", "batch", "kv_seq", "kv", None),
        "v": ("layer", "batch", "kv_seq", "kv", None),
        "len": (),
    }


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend_embeds=None, max_len=None):
    """Returns (last-position logits (B,V) float32, cache).  ``max_len``
    is ignored: the ring buffer and the recurrent state are O(window).

    Each attention layer's ring buffer holds the last ``window``
    positions at slot ``p % window``: when S >= window, the last window
    of K/V rolled by S % window; else K/V padded with zeros."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=x.device)
    win = cfg.window
    # each layer's state is copied into the cache as it is made, so no
    # layer's (B, S, W) activations stay alive behind a view of its tail
    cache = cm.zeros_from_specs(cache_specs(cfg, b, s), x.dtype, x.device)
    ri = ai = 0
    for kind in layer_kinds(cfg):
        if kind == "rec":
            x, (cache["h"][ri], cache["conv"][ri]) = rec_block(
                cfg, cm.pick(params["rec"], ri), x)
            ri += 1
        else:
            x, (k, v) = attn_block(cfg, cm.pick(params["attn"], ai), x,
                                   positions)
            if s >= win:
                cache["k"][ai] = torch.roll(k[:, -win:], s % win, dims=1)
                cache["v"][ai] = torch.roll(v[:, -win:], s % win, dims=1)
            else:                        # slots s.. stay zero
                cache["k"][ai, :, :s] = k
                cache["v"][ai, :, :s] = v
            ai += 1
    cache["len"] = s
    return cm.final_logits(cfg, params, x[:, -1]), cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """token (B,) int; cache from ``prefill``.  One-token step: the
    recurrent layers advance h by one step of the recurrence, the
    attention layers write K/V at slot ``pos % window`` and attend over
    the ``min(pos + 1, window)`` filled slots.  Returns (logits (B,V)
    float32, cache), the cache updated in place."""
    pos = int(cache["len"])
    win = cfg.window
    x = params["embed"][token[:, None]]                  # (B,1,D)
    positions = torch.arange(pos, pos + 1, device=x.device)
    slot = pos % win
    ri = ai = 0
    for kind in layer_kinds(cfg):
        if kind == "rec":
            p = cm.pick(params["rec"], ri)
            h_in = cm.rms_norm(x, p["ln"], cfg.norm_eps)
            main = h_in @ p["w_main"]
            gate = cm.gelu((h_in @ p["w_gate"]).float())
            u, ct = causal_conv(main, p["conv"], cache["conv"][ri])
            log_a, gated = rglru_gates(p, u)
            h_new = torch.exp(log_a[:, 0]) * cache["h"][ri] + gated[:, 0]
            y = (h_new[:, None, :] * gate).to(x.dtype)
            x = cm.geglu_block(cfg, p, x + y @ p["w_out"])
            cache["h"][ri] = h_new
            cache["conv"][ri] = ct
            ri += 1
        else:
            p = cm.pick(params["attn"], ai)
            q, k, v = _attn_qkv(cfg, p, x, positions)
            cache["k"][ai, :, slot] = k[:, 0]
            cache["v"][ai, :, slot] = v[:, 0]
            o = attn.decode_attention(q, cache["k"][ai], cache["v"][ai],
                                      min(pos + 1, win))
            x = _attn_out(cfg, p, x, o)
            ai += 1
    logits = cm.final_logits(cfg, params, x[:, 0])
    cache["len"] = pos + 1
    return logits, cache
