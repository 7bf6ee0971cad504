"""Encoder-decoder transformer, PyTorch port of ``repro.models.encdec``
(the seamless-m4t-medium text/audio backbone).

The audio frontend is a stub: the caller gives precomputed frame
embeddings (B, S_enc, frontend_dim), and a learned projection maps them
to d_model.  Encoder: non-causal self-attention with RoPE + SwiGLU.
Decoder: causal self-attention with RoPE, non-causal cross-attention to
the encoder output (no RoPE), SwiGLU.  Every attention goes through the
kernels (:mod:`repro_torch.models.attention`): ``flash_attention`` in the
encoder, in the decoder's prefill and in its cross-attention (more
queries than keys), ``decode_attention`` in each decode step, once
against the self cache and once against the cross cache, whose every
position is valid.

The decoder's length sets the encoder's: ``S_enc = max(S // 4, 64)``
frames (:func:`enc_len`).  The cache is ``{"k", "v": (L, B, max_len,
Hkv, hd), "xk", "xv": (L, B, S_enc, Hkv, hd), "len": int}``: ``prefill``
stores the cross K/V at the length of the frame embeddings it was given,
and ``cache_specs`` sizes them by ``enc_len(max_len)``, as the JAX
package does; decode reads what prefill wrote.  ``decode_step`` writes
the self K/V **in place** (the JAX version builds new arrays) and
returns a dict that shares the cache tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.engine_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig


def enc_len(cfg: ModelConfig, dec_len: int) -> int:
    return max(dec_len // 4, 64)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig, prefix: str = "w") -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {f"{prefix}q": (d, h, hd), f"{prefix}k": (d, hkv, hd),
            f"{prefix}v": (d, hkv, hd), f"{prefix}o": (h, hd, d)}


def _enc_layer_specs(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {"ln1": (d,), **_attn_specs(cfg), "ln2": (d,),
            "mlp": {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}}


def _dec_layer_specs(cfg: ModelConfig) -> dict:
    return {**_enc_layer_specs(cfg), "ln_x": (cfg.d_model,),
            **_attn_specs(cfg, "x")}


_ENC_AXES = {
    "ln1": (None,),
    "wq": ("embed", "heads", None),
    "wk": ("embed", "kv", None),
    "wv": ("embed", "kv", None),
    "wo": ("heads", None, "embed"),
    "ln2": (None,),
    "mlp": dict(cm.MLP_AXES),
}

_DEC_AXES = dict(_ENC_AXES, **{
    "ln_x": (None,),
    "xq": ("embed", "heads", None),
    "xk": ("embed", "kv", None),
    "xv": ("embed", "kv", None),
    "xo": ("heads", None, "embed"),
})


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree with a shape tuple at every leaf (no alloc)."""
    n_enc = cfg.n_enc_layers or cfg.n_layers
    return {
        "frontend_proj": (cfg.frontend_dim, cfg.d_model),
        "embed": (cfg.vocab, cfg.d_model),
        "enc": cm.stacked(n_enc, _enc_layer_specs(cfg)),
        "enc_norm": (cfg.d_model,),
        "dec": cm.stacked(cfg.n_layers, _dec_layer_specs(cfg)),
        "final_norm": (cfg.d_model,),
        "lm_head": (cfg.d_model, cfg.vocab),
    }


def logical_axes(cfg: ModelConfig) -> dict:
    return {
        "frontend_proj": (None, "embed"),
        "embed": ("vocab", "embed"),
        "enc": cm.stacked_axes(_ENC_AXES),
        "enc_norm": (None,),
        "dec": cm.stacked_axes(_DEC_AXES),
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


def init(cfg: ModelConfig, generator: torch.Generator, *,
         device=None) -> dict:
    """Random parameters with the JAX package's scales: norms 0,
    embeddings N(0, 0.02), projections N(0, 1/fan_in) (``wo``/``xo``
    over heads x hd).  ``generator`` must live on ``device`` (``None``
    means CUDA and raises without it)."""
    dev = resolve_device(device, "the model")
    dt = cfg.dtype

    def stack(specs: dict, n: int) -> dict:
        out = {}
        for k, shape in specs.items():
            if isinstance(shape, dict):
                out[k] = stack(shape, n)
            elif k.startswith("ln"):
                out[k] = torch.zeros((n,) + shape, dtype=dt, device=dev)
            else:
                in_axis = (1, 2) if k in ("wo", "xo") else 1
                out[k] = cm.dense_init(generator, (n,) + shape, dt, in_axis,
                                       device=dev)
        return out

    d = cfg.d_model
    return {
        "frontend_proj": cm.dense_init(generator, (cfg.frontend_dim, d), dt,
                                       device=dev),
        "embed": cm.embed_init(generator, (cfg.vocab, d), dt, device=dev),
        "enc": stack(_enc_layer_specs(cfg), cfg.n_enc_layers or cfg.n_layers),
        "enc_norm": torch.zeros((d,), dtype=dt, device=dev),
        "dec": stack(_dec_layer_specs(cfg), cfg.n_layers),
        "final_norm": torch.zeros((d,), dtype=dt, device=dev),
        "lm_head": cm.dense_init(generator, (d, cfg.vocab), dt, device=dev),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ w (D, H, hd) -> (B, S, H, hd)."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def _merge(x: torch.Tensor, o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Residual plus o (B, S, H, hd) @ w (H, hd, D)."""
    b, s, h, hd = o.shape
    return x + o.reshape(b, s, h * hd) @ w.reshape(h * hd, -1)


def _self_qkv(cfg: ModelConfig, lp: dict, x: torch.Tensor,
              positions: torch.Tensor):
    h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = cm.apply_rope(_heads(h, lp["wq"]), positions, cfg.rope_theta)
    k = cm.apply_rope(_heads(h, lp["wk"]), positions, cfg.rope_theta)
    return q, k, _heads(h, lp["wv"])


def _mlp_block(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    return x + cm.mlp_forward(lp["mlp"], cm.rms_norm(x, lp["ln2"],
                                                     cfg.norm_eps))


def _cross_q(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    return _heads(cm.rms_norm(x, lp["ln_x"], cfg.norm_eps), lp["xq"])


def _enc_layer(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    q, k, v = _self_qkv(cfg, lp, x, positions)
    o = attn.multi_head_attention(q, k, v, causal=False)
    return _mlp_block(cfg, lp, _merge(x, o, lp["wo"]))


def encode(cfg: ModelConfig, params: dict,
           frontend_embeds: torch.Tensor) -> torch.Tensor:
    """Frame embeddings (B, S_enc, frontend_dim), cast to the model's
    dtype -> the encoder output (B, S_enc, D).  Under grad,
    ``cfg.remat`` recomputes each layer in the backward, as the JAX
    package's ``scan_layers`` does."""
    x = frontend_embeds.to(cfg.dtype) @ params["frontend_proj"]
    positions = torch.arange(x.shape[1], device=x.device)
    block = cm.maybe_remat(cfg, _enc_layer)
    for lp in cm.unstack(params["enc"], cfg.n_enc_layers or cfg.n_layers):
        x = block(cfg, lp, x, positions)
    return cm.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               enc_out: torch.Tensor, positions: torch.Tensor):
    """One decoder layer over the whole sequence -> (x, (k, v, kx, vx))."""
    q, k, v = _self_qkv(cfg, lp, x, positions)
    o = attn.multi_head_attention(q, k, v, causal=True)
    x = _merge(x, o, lp["wo"])
    kx, vx = _heads(enc_out, lp["xk"]), _heads(enc_out, lp["xv"])
    ox = attn.multi_head_attention(_cross_q(cfg, lp, x), kx, vx,
                                   causal=False)
    x = _mlp_block(cfg, lp, _merge(x, ox, lp["xo"]))
    return x, (k, v, kx, vx)


def _frames(frontend_embeds) -> torch.Tensor:
    if frontend_embeds is None:
        raise ValueError("encdec requires frontend embeds")
    return frontend_embeds


# ---------------------------------------------------------------------------
# Forward (scoring)
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None,
            return_aux: bool = False):
    """tokens (B, S_dec), frontend_embeds (B, S_enc, F) -> logits (B,
    S_dec, V) float32 [+ aux loss 0].  Trainable: under grad,
    ``cfg.remat`` recomputes each encoder and decoder layer in the
    backward (:func:`common.maybe_remat`)."""
    enc_out = encode(cfg, params, _frames(frontend_embeds))
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=x.device)
    block = cm.maybe_remat(cfg, _dec_layer)
    for lp in cm.unstack(params["dec"], cfg.n_layers):
        x, _ = block(cfg, lp, x, enc_out, positions)
    logits = cm.final_logits(cfg, params, x)
    if return_aux:
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)
    return logits


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    l, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    se = enc_len(cfg, max_len)
    return {"k": (l, batch, max_len, hkv, hd),
            "v": (l, batch, max_len, hkv, hd),
            "xk": (l, batch, se, hkv, hd), "xv": (l, batch, se, hkv, hd),
            "len": ()}


def cache_axes(cfg: ModelConfig) -> dict:
    ax = ("layer", "batch", "kv_seq", "kv", None)
    return {"k": ax, "v": ax, "xk": ax, "xv": ax, "len": ()}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Encoder pass + decoder prefill; the cross K/V computed once.

    Returns (last-position logits (B, V) float32, cache).  The self
    cache is allocated once at ``max_len`` (default S + 64, at least S);
    the cross cache at the frames' length."""
    enc_out = encode(cfg, params, _frames(frontend_embeds))
    x = params["embed"][tokens]
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)
    cap = max(max_len if max_len is not None else s + 64, s)
    shape = (cfg.n_layers, b, cap, cfg.n_kv_heads, cfg.hd)
    xshape = (cfg.n_layers, b, enc_out.shape[1], cfg.n_kv_heads, cfg.hd)
    ks = torch.zeros(shape, dtype=x.dtype, device=x.device)
    vs = torch.zeros(shape, dtype=x.dtype, device=x.device)
    xks = torch.empty(xshape, dtype=x.dtype, device=x.device)
    xvs = torch.empty(xshape, dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        x, (k, v, kx, vx) = _dec_layer(cfg, cm.pick(params["dec"], i), x,
                                       enc_out, positions)
        ks[i, :, :s] = k
        vs[i, :, :s] = v
        xks[i] = kx
        xvs[i] = vx
    logits = cm.final_logits(cfg, params, x[:, -1])
    return logits, {"k": ks, "v": vs, "xk": xks, "xv": xvs, "len": s}


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """token (B,) int; cache from ``prefill``.  One-token step.

    Returns (logits (B, V) float32, cache): the new token's K/V written
    in place at position ``cache["len"]``, which the returned dict
    advances by one."""
    n = int(cache["len"])
    ks, vs, xks, xvs = cache["k"], cache["v"], cache["xk"], cache["xv"]
    if n >= ks.shape[2]:
        raise ValueError(f"decode_step: the cache holds {ks.shape[2]} "
                         f"positions and all are used")
    x = params["embed"][token[:, None]]                      # (B,1,D)
    b = x.shape[0]
    positions = torch.arange(n, n + 1, device=x.device)
    lengths = torch.full((b,), n + 1, dtype=torch.int32, device=x.device)
    xlengths = torch.full((b,), xks.shape[2], dtype=torch.int32,
                          device=x.device)
    for i in range(cfg.n_layers):
        lp = cm.pick(params["dec"], i)
        q, k, v = _self_qkv(cfg, lp, x, positions)
        ks[i, :, n] = k[:, 0]
        vs[i, :, n] = v[:, 0]
        o = attn.decode_attention(q, ks[i], vs[i], lengths)
        x = _merge(x, o, lp["wo"])
        ox = attn.decode_attention(_cross_q(cfg, lp, x), xks[i], xvs[i],
                                   xlengths)
        x = _mlp_block(cfg, lp, _merge(x, ox, lp["xo"]))
    logits = cm.final_logits(cfg, params, x[:, 0])
    return logits, {"k": ks, "v": vs, "xk": xks, "xv": xvs, "len": n + 1}
