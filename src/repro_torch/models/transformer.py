"""Decoder-only transformer, PyTorch port of ``repro.models.transformer``.

Covers the dense configs (qwen3-4b with QK-norm, phi3-medium-14b,
glm4-9b, deepseek-coder-33b), the MoE configs (olmoe-1b-7b,
moonshot-v1-16b-a3b: the SwiGLU MLP becomes
:func:`repro_torch.models.moe.moe_ffn`) and the pixtral-12b backbone
(the patch frontend stub: the first ``nf`` positions take the given
patch embeddings times ``frontend_proj``).  Layer: pre-RMSNorm -> GQA
attention (RoPE, optional QK-norm, optional sliding window) -> residual
-> pre-RMSNorm -> SwiGLU MLP or MoE -> residual.  Attention goes through
the kernels (:mod:`repro_torch.models.attention`).

The mesh options act under an active mesh (``parallel.ctx.use_mesh``),
which on the port's one card is logical (``repro_torch.launch.mesh``):
``tp_attention`` gives the forward the JAX package's TP-aligned
attention weights (:func:`tp_attn_weights`: one kv head per q head,
heads zero-padded to a multiple of the ``model`` axis, the same flash
kernel run with ``Hkv = H_eff``); ``sp_decode`` runs each decode step's
attention as flash-decoding over the ``model`` axis's sequence shards
(:func:`repro_torch.models.attention.decode_attention_sp`).  Under a
mesh a MoE layer takes the expert-parallel path
(:func:`repro_torch.models.moe.moe_ffn_sharded`).

Parameters keep the JAX tree, layers stacked on a leading ``L``
dimension (a MoE layer's experts under ``"moe"``, and no ``"mlp"``);
the KV cache is ``{"k", "v": (L, B, max_len, Hkv, hd), "len": int}``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.engine_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe
from repro_torch.models.common import ModelConfig
from repro_torch.parallel import ctx as pctx


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _layer_specs(cfg: ModelConfig) -> dict:
    d, h, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         cfg.d_ff)
    p = {
        "ln1": (d,),
        "wq": (d, h, hd),
        "wk": (d, hkv, hd),
        "wv": (d, hkv, hd),
        "wo": (h, hd, d),
        "ln2": (d,),
    }
    if cfg.n_experts > 0:
        p["moe"] = moe.moe_specs(cfg)
    else:
        p["mlp"] = {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
    if cfg.qk_norm:
        p["q_norm"] = (hd,)
        p["k_norm"] = (hd,)
    return p


def _layer_axes(cfg: ModelConfig) -> dict:
    p = {
        "ln1": (None,),
        "wq": ("embed", "heads", None),
        "wk": ("embed", "kv", None),
        "wv": ("embed", "kv", None),
        "wo": ("heads", None, "embed"),
        "ln2": (None,),
    }
    if cfg.n_experts > 0:
        p["moe"] = dict(moe.MOE_AXES)
    else:
        p["mlp"] = dict(cm.MLP_AXES)
    if cfg.qk_norm:
        p["q_norm"] = (None,)
        p["k_norm"] = (None,)
    return p


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree with a shape tuple at every leaf (no alloc);
    the MoE router is a ``common.F32`` shape."""
    p = {
        "embed": (cfg.vocab, cfg.d_model),
        "layers": cm.stacked(cfg.n_layers, _layer_specs(cfg)),
        "final_norm": (cfg.d_model,),
        "lm_head": (cfg.d_model, cfg.vocab),
    }
    if cfg.frontend:
        p["frontend_proj"] = (cfg.frontend_dim, cfg.d_model)
    return p


def logical_axes(cfg: ModelConfig) -> dict:
    p = {
        "embed": ("vocab", "embed"),
        "layers": cm.stacked_axes(_layer_axes(cfg)),
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }
    if cfg.frontend:
        p["frontend_proj"] = (None, "embed")
    return p


def init(cfg: ModelConfig, generator: torch.Generator, *,
         device=None) -> dict:
    """Random parameters at the config's shapes and dtype, with the JAX
    package's scales: norms 0, embeddings N(0, 0.02), projections
    N(0, 1/fan_in); the MoE router float32.  ``generator`` must live
    on ``device`` (``None`` means CUDA and raises without it)."""
    dev = resolve_device(device, "the model")
    dt, n = cfg.dtype, cfg.n_layers

    def dense(shape, in_axis=1):
        return cm.dense_init(generator, (n,) + shape, dt, in_axis,
                             device=dev)

    d, h, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         cfg.d_ff)
    layers = {
        "ln1": torch.zeros((n, d), dtype=dt, device=dev),
        "wq": dense((d, h, hd)),
        "wk": dense((d, hkv, hd)),
        "wv": dense((d, hkv, hd)),
        "wo": dense((h, hd, d), in_axis=(1, 2)),
        "ln2": torch.zeros((n, d), dtype=dt, device=dev),
    }
    if cfg.n_experts > 0:
        layers["moe"] = moe.moe_params(generator, cfg, n, device=dev)
    else:
        layers["mlp"] = {"w_gate": dense((d, ff)), "w_up": dense((d, ff)),
                         "w_down": dense((ff, d))}
    if cfg.qk_norm:
        layers["q_norm"] = torch.zeros((n, hd), dtype=dt, device=dev)
        layers["k_norm"] = torch.zeros((n, hd), dtype=dt, device=dev)
    params = {
        "embed": cm.embed_init(generator, (cfg.vocab, d), dt, device=dev),
        "layers": layers,
        "final_norm": torch.zeros((d,), dtype=dt, device=dev),
        "lm_head": cm.dense_init(generator, (d, cfg.vocab), dt, device=dev),
    }
    if cfg.frontend:
        params["frontend_proj"] = cm.dense_init(
            generator, (cfg.frontend_dim, d), dt, device=dev)
    return params


def layer(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return cm.pick(params["layers"], i)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def tp_attn_weights(cfg: ModelConfig, lp: dict):
    """TP-aligned attention weights (``cfg.tp_attention``), the JAX
    package's ``tp_attn_weights``: under an active mesh with a
    ``model`` axis of size ``tp``, (a) the KV projection weights are
    repeated to one kv head per q head (identical k/v values per group)
    and (b) the q/kv/o head dims are zero-padded to a multiple of ``tp``
    (padded o-rows are zero, so outputs are unchanged up to the order of
    sums).  Without the option, a mesh or a ``model`` axis the weights
    pass unchanged.  The JAX version also pins each weight's sharding
    (heads over ``model``), which changes no value and has no
    counterpart on one card.  Returns (wq, wk, wv, wo, h_eff)."""
    mesh = pctx.get_mesh()
    wq, wk, wv, wo = lp["wq"], lp["wk"], lp["wv"], lp["wo"]
    h = cfg.n_heads
    if not cfg.tp_attention or mesh is None or "model" not in \
            mesh.axis_names:
        return wq, wk, wv, wo, h
    tp = mesh.shape["model"]
    wk = wk.repeat_interleave(cfg.q_per_kv, dim=1)   # one kv head per q
    wv = wv.repeat_interleave(cfg.q_per_kv, dim=1)
    h_eff = -(-h // tp) * tp                         # ceil to TP multiple
    if h_eff != h:
        wq, wk, wv = (F.pad(w, (0, 0, 0, h_eff - h)) for w in (wq, wk, wv))
        wo = F.pad(wo, (0, 0, 0, 0, 0, h_eff - h))
    return wq, wk, wv, wo, h_eff


def _qkv(cfg: ModelConfig, lp: dict, x: torch.Tensor,
         positions: torch.Tensor, w=None):
    """Pre-norm, projections, QK-norm and RoPE -> q (B,S,H,hd), k and v
    (B,S,Hkv,hd); ``w`` = (wq, wk, wv) in place of ``lp``'s (the head
    counts are the weights')."""
    b, s, d = x.shape
    wq, wk, wv = w or (lp["wq"], lp["wk"], lp["wv"])
    h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = (h @ wq.reshape(d, -1)).view(b, s, wq.shape[1], cfg.hd)
    k = (h @ wk.reshape(d, -1)).view(b, s, wk.shape[1], cfg.hd)
    v = (h @ wv.reshape(d, -1)).view(b, s, wv.shape[1], cfg.hd)
    if cfg.qk_norm:
        q = cm.head_rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = cm.head_rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(wo: torch.Tensor, x: torch.Tensor,
              o: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = o.shape
    return x + o.reshape(b, s, h * hd) @ wo.reshape(h * hd, -1)


def _ffn_block(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               aux: bool = False):
    """Returns (x_out, the MoE aux loss: ``None`` unless ``aux`` and the
    layer is a MoE)."""
    h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.n_experts > 0:
        y, a = moe.moe_ffn(cfg, lp["moe"], h, aux=aux)
        return x + y, a
    return x + cm.mlp_forward(lp["mlp"], h), None


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings; with a frontend, the first ``nf`` positions are
    the frontend embeddings (B, nf, frontend_dim), cast to the model's
    dtype, times ``frontend_proj``."""
    x = params["embed"][tokens]
    if cfg.frontend and frontend_embeds is not None:
        fe = frontend_embeds.to(cfg.dtype) @ params["frontend_proj"]
        x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
    return x


# ---------------------------------------------------------------------------
# Forward (scoring)
# ---------------------------------------------------------------------------


def _block(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
           lp: dict, aux: bool = False):
    """One decoder layer of the scoring / training forward -> (x, aux
    loss or ``None``); under ``tp_attention`` and a mesh the attention
    runs on :func:`tp_attn_weights`."""
    wq, wk, wv, wo, _ = tp_attn_weights(cfg, lp)
    q, k, v = _qkv(cfg, lp, x, positions, (wq, wk, wv))
    o = attn.multi_head_attention(q, k, v, causal=True, window=cfg.window)
    return _ffn_block(cfg, lp, _out_proj(wo, x, o), aux)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend_embeds=None, return_aux: bool = False):
    """tokens (B, S) -> logits (B, S, V) float32 [+ the MoE aux loss, its
    mean over layers; 0 for a dense model].

    Trainable: under grad, ``cfg.remat`` recomputes each layer in the
    backward (:func:`common.maybe_remat`, the JAX package's
    ``maybe_remat``), and the per-layer parameters are taken by one
    ``unbind`` of each stacked leaf (:func:`common.unstack`), whose
    backward stacks the layers' gradients once."""
    x = embed_tokens(cfg, params, tokens, frontend_embeds)
    positions = torch.arange(tokens.shape[1], device=x.device)
    block = cm.maybe_remat(cfg, _block)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in cm.unstack(params["layers"], cfg.n_layers):
        x, a = block(cfg, x, positions, lp, return_aux)
        if a is not None:
            aux = aux + a
    logits = cm.final_logits(cfg, params, x)
    if return_aux:
        return logits, aux / cfg.n_layers
    return logits


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend_embeds=None,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Returns (last-position logits (B,V) float32, kv cache).

    The cache ``{"k": (L,B,max_len,Hkv,hd), "v": ..., "len": S}`` is
    allocated once at ``max_len`` (default S + 64, at least S) and
    filled layer by layer; positions from S on are zero until decode
    writes them."""
    x = embed_tokens(cfg, params, tokens, frontend_embeds)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)
    cap = max(max_len if max_len is not None else s + 64, s)
    shape = (cfg.n_layers, b, cap, cfg.n_kv_heads, cfg.hd)
    ks = torch.zeros(shape, dtype=x.dtype, device=x.device)
    vs = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        q, k, v = _qkv(cfg, lp, x, positions)
        ks[i, :, :s] = k
        vs[i, :, :s] = v
        o = attn.multi_head_attention(q, k, v, causal=True,
                                      window=cfg.window)
        x, _ = _ffn_block(cfg, lp, _out_proj(lp["wo"], x, o))
    logits = cm.final_logits(cfg, params, x[:, -1])
    return logits, {"k": ks, "v": vs, "len": s}


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """token (B,) int; cache from ``prefill``.  One-token step.

    Returns (logits (B,V) float32, cache).  The new token's K/V are
    written **in place** into ``cache["k"]``/``cache["v"]`` at position
    ``cache["len"]`` (the JAX version builds new arrays), and the
    returned dict shares those tensors with ``len + 1``.

    Under ``cfg.sp_decode`` each layer's attention is
    :func:`~repro_torch.models.attention.decode_attention_sp`
    (flash-decoding over the active mesh's ``model`` axis).  The JAX
    version first pins the cache slice's layout (``_pin_seq_sharding``:
    sequence over ``model``, batch over the data axes), which changes
    no value and has no counterpart on one card."""
    n = int(cache["len"])
    ks, vs = cache["k"], cache["v"]
    if n >= ks.shape[2]:
        raise ValueError(f"decode_step: the cache holds {ks.shape[2]} "
                         f"positions and all are used")
    x = params["embed"][token[:, None]]                      # (B,1,D)
    positions = torch.arange(n, n + 1, device=x.device)
    lengths = torch.full((x.shape[0],), n + 1, dtype=torch.int32,
                         device=x.device)
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        q, k, v = _qkv(cfg, lp, x, positions)
        ks[i, :, n] = k[:, 0]
        vs[i, :, n] = v[:, 0]
        if cfg.sp_decode:
            o = attn.decode_attention_sp(q, ks[i], vs[i], lengths)
        else:
            o = attn.decode_attention(q, ks[i], vs[i], lengths)
        x, _ = _ffn_block(cfg, lp, _out_proj(lp["wo"], x, o))
    logits = cm.final_logits(cfg, params, x[:, 0])
    return logits, {"k": ks, "v": vs, "len": n + 1}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    shp = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": shp, "v": shp, "len": ()}


def cache_axes(cfg: ModelConfig) -> dict:
    ax = ("layer", "batch", "kv_seq", "kv", None)
    return {"k": ax, "v": ax, "len": ()}
