"""Common model-definition machinery, PyTorch port of ``repro.models.common``.

Parameters are plain nested dicts of tensors with the JAX package's
tree: per-layer parameters are stacked with a leading ``L`` dimension
(``params["layers"]["wq"]`` is ``(L, d, H, hd)``), so a JAX parameter
tree crosses to the port leaf for leaf (``repro_torch.models.convert``)
and both packages compute the same function.  A Python loop over the
leading dimension stands in for ``lax.scan``; :func:`maybe_remat` is
the JAX package's remat for training.

Every function keeps the JAX arithmetic: norms, RoPE and the SiLU run
in float32 and cast back to the input's dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | xlstm | rglru | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default: d_model // n_heads
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- recurrentgemma / hybrid ---
    window: int = 0                  # sliding local-attention window (0 = full)
    lru_width: int = 0
    attn_every: int = 0              # 1 attention block per `attn_every` blocks
    # --- xlstm ---
    slstm_every: int = 0             # 1 sLSTM block per `slstm_every` blocks
    mlstm_proj_factor: float = 2.0
    slstm_ff_factor: float = 4.0 / 3.0
    # --- encoder-decoder ---
    n_enc_layers: int = 0            # if >0, family == encdec
    # --- multimodal frontend stubs ---
    frontend: str = ""               # "" | "patch" | "audio"
    frontend_dim: int = 0            # raw embedding dim provided by the stub
    n_frontend_tokens: int = 0       # tokens contributed by the frontend
    # --- numerics ---
    dtype: Any = torch.bfloat16
    # --- training-time knobs (overridable per shape) ---
    remat: bool = True
    scan_layers: bool = True
    # --- optimization knobs of the JAX package (tp_attention and
    # sp_decode act under an active mesh) ---
    tp_attention: bool = False
    sp_decode: bool = False
    gather_weights_once: bool = False
    remat_policy: str = "nothing"
    causal_slice: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def n_params(self) -> int:
        """Parameter count, derived from the parameter shapes (no alloc)."""
        from repro_torch.models import registry

        def count(tree) -> int:
            if isinstance(tree, dict):
                return sum(count(v) for v in tree.values())
            return math.prod(tree)

        return int(count(registry.param_specs(self)))


class F32(tuple):
    """A leaf of ``param_specs``: the shape of a parameter that is
    float32 whatever the model's dtype (the recurrent families' gate
    weights).  A plain tuple leaf takes the model's dtype."""


def stacked(n: int, tree: dict) -> dict:
    """Shapes of ``tree`` with a leading layer dimension ``n``, keeping
    the ``F32`` marker."""
    return {k: stacked(n, v) if isinstance(v, dict)
            else type(v)((n,) + tuple(v)) for k, v in tree.items()}


def stacked_axes(axes_one: dict) -> dict:
    """Logical axes of a stacked layer tree: ``"layer"`` before each
    leaf's axes."""
    return {k: stacked_axes(v) if isinstance(v, dict) else ("layer",) + v
            for k, v in axes_one.items()}


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, dtype, in_axis=0,
               device=None) -> torch.Tensor:
    """Normal(0, 1/fan_in) in float32, cast to ``dtype``; ``in_axis`` is
    an axis or a tuple of axes whose sizes multiply to the fan-in."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else math.prod(
        shape[a] for a in in_axis)
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype,
               device=None) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """QK-norm: RMS over the head_dim of a (..., H, hd) tensor."""
    return rms_norm(x, scale, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,).  Half-split rotation
    (the first and second halves of hd pair up), in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)      # (hd/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs           # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


MLP_AXES = {
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
}


def mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def geglu_block(cfg: "ModelConfig", p: dict, x: torch.Tensor) -> torch.Tensor:
    """The recurrent families' residual GeGLU feed-forward: pre-norm
    ``ln2``, ``ff1`` to [gate, up], GeLU of the gate in float32,
    ``ff2``."""
    xf = rms_norm(x, p["ln2"], cfg.norm_eps)
    g, u = (xf @ p["ff1"]).chunk(2, dim=-1)
    return x + (gelu(g.float()).to(x.dtype) * u) @ p["ff2"]


# ---------------------------------------------------------------------------
# Model assembly
# ---------------------------------------------------------------------------


def pick(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter tree: views, nested dicts
    included."""
    return {k: pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unstack(tree: dict, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree, each leaf split once
    by ``unbind(0)``.  Under autograd, indexing a stacked leaf per layer
    would give every layer's backward a zero-filled gradient of the whole
    leaf; ``unbind``'s backward stacks the layers' gradients once."""
    out = [dict() for _ in range(n)]

    def walk(sub, dst):
        for k, v in sub.items():
            if isinstance(v, dict):
                children = [d.setdefault(k, {}) for d in dst]
                walk(v, children)
            else:
                for d, t in zip(dst, v.unbind(0)):
                    d[k] = t
    walk(tree, out)
    return out


#: the remat policies, as the JAX package names them: "nothing" saves no
#: intermediate (``nothing_saveable``); "dots" saves the outputs of the
#: products with no batch dimension (``dots_with_no_batch_dims_saveable``)
REMAT_POLICIES = ("nothing", "dots")


def _dots_contexts():
    """Selective checkpointing's contexts for the policy "dots": the
    outputs of ``aten.mm`` and ``aten.addmm`` (``x @ w`` of a projection,
    whatever the leading dims of ``x``) are kept from the forward; every
    other operation, ``bmm`` (the experts' batched products) and the
    attention and recurrence kernels included, is recomputed."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    aten = torch.ops.aten
    return create_selective_checkpoint_contexts(
        [aten.mm.default, aten.addmm.default])


def maybe_remat(cfg: "ModelConfig", fn):
    """``fn`` recomputed in the backward when ``cfg.remat`` and grad mode
    is on (``torch.utils.checkpoint``, non-reentrant), else ``fn``
    itself: the JAX package's ``maybe_remat``.  Under the policy
    "nothing" no intermediate is saved; under "dots" the products with no
    batch dimension are (:func:`_dots_contexts`)."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"{cfg.name}: remat_policy {cfg.remat_policy!r}, "
                         f"expected one of {REMAT_POLICIES}")
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    from torch.utils.checkpoint import checkpoint

    kw = {"context_fn": _dots_contexts} if cfg.remat_policy == "dots" else {}

    def remat(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return remat


def zeros_from_specs(specs: dict, dtype, device) -> dict:
    """A zero state at the shapes of a ``cache_specs`` dict: ``F32``
    leaves float32, the others ``dtype``, and ``len`` 0."""
    return {k: 0 if k == "len" else torch.zeros(
                shape, device=device,
                dtype=torch.float32 if isinstance(shape, F32) else dtype)
            for k, shape in specs.items()}


def final_logits(cfg: "ModelConfig", params: dict,
                 x: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head -> float32 logits."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 1e-4) -> torch.Tensor:
    """logits (..., V) any float dtype; labels (...) int. Returns the
    mean loss (float32)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss.mean()
