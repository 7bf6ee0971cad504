"""The gradient of the port's attention on the CPU.

``ref.attention_flat_bwd_plain`` (the explicit formulas that the
backward kernel ``csrc/flash_attention_bwd.cu`` computes) against torch
autograd of ``ref.attention_flat_plain`` and against ``jax.grad`` of the
JAX package's attention (``repro.models.attention.multi_head_attention``,
which the JAX models differentiate), at the edge shapes of chip_smoke's
``flash_attention_bwd`` phase: GQA, a padded tail, windows (one narrower
than a key tile), fewer queries than keys under the causal mask, head
dims that are not multiples of 16, and Sk = 0.  Then
``flash_attention.FlashAttention`` end to end on CPU tensors: the
(B, S, H, hd) entry point under grad goes through it and its backward
calls ``flash_attention_bwd``, whose CPU path is the plain version.

Inputs from numpy with a seed, float32.  Tolerance: 1e-5 x max(1,
largest |gradient|): the same float32 functions with sums in another
order (the plain backward uses the forward's output in D = dO . o,
autograd and JAX differentiate through the softmax).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import multi_head_attention as jattention
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_bwd)
from repro_torch.kernels.ref import (attention_flat_bwd_plain,
                                     attention_flat_plain)

TOL = 1e-5
#: (B, H, Hkv, Sq, Sk, hd, causal, window)
SHAPES = [(2, 4, 2, 37, 37, 16, True, 0),          # GQA, odd length
          (1, 8, 2, 96, 96, 32, True, 0),          # padded tail
          (1, 2, 1, 80, 80, 64, True, 64),         # window
          (1, 4, 2, 70, 70, 40, True, 5),          # window < a key tile
          (1, 4, 2, 50, 120, 24, True, 0),         # Sq < Sk, causal
          (1, 2, 2, 30, 60, 8, False, 0),          # cross attention
          (2, 6, 3, 33, 33, 128, True, 0)]         # hd 128
EMPTY = [(1, 4, 2, 20, 0, 16, True, 0), (2, 2, 1, 0, 12, 8, True, 0)]


def _inputs(b, h, hkv, sq, sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, sq, h, hd), f(b, sk, hkv, hd), f(b, sk, hkv, hd), \
        f(b, sq, h, hd)


def _flat(t: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = t.shape
    return t.transpose(1, 2).reshape(b * h, s, hd)


def _bshd(t: torch.Tensor, b: int) -> torch.Tensor:
    bh, s, hd = t.shape
    return t.reshape(b, bh // b, s, hd).transpose(1, 2)


def _plain_grads(q, k, v, do, causal, window):
    """attention_flat_bwd_plain on (B, S, H, hd) numpy inputs."""
    b = q.shape[0]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = attention_flat_plain(_flat(tq), _flat(tk), _flat(tv), causal=causal,
                             window=window)
    grads = attention_flat_bwd_plain(_flat(tq), _flat(tk), _flat(tv), o,
                                     _flat(tdo), causal=causal,
                                     window=window)
    return [_bshd(g, b).numpy() for g in grads]


def _close(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert float(np.abs(got - want).max(initial=0.0)) <= TOL * scale


@pytest.mark.parametrize("shape", SHAPES + EMPTY)
def test_plain_backward_equals_autograd(shape):
    b, h, hkv, sq, sk, hd, causal, window = shape
    q, k, v, do = _inputs(b, h, hkv, sq, sk, hd)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = _bshd(attention_flat_plain(_flat(tq), _flat(tk), _flat(tv),
                                   causal=causal, window=window), b)
    want = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(_plain_grads(q, k, v, do, causal, window), want):
        _close(g, w.numpy())


@pytest.mark.parametrize("shape", SHAPES + EMPTY[:1])
def test_plain_backward_equals_jax_grad(shape):
    b, h, hkv, sq, sk, hd, causal, window = shape
    q, k, v, do = _inputs(b, h, hkv, sq, sk, hd, seed=1)

    def loss(q, k, v):
        o = jattention(q, k, v, causal=causal, window=window)
        return jnp.sum(o * do)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, w in zip(_plain_grads(q, k, v, do, causal, window), want):
        _close(g, np.asarray(w))


def test_sk_zero_gives_zero_gradients():
    q, k, v, do = _inputs(1, 4, 2, 20, 0, 16)
    dq, dk, dv = _plain_grads(q, k, v, do, True, 0)
    assert dq.shape == q.shape and not np.any(dq) and not np.isnan(dq).any()
    assert dk.shape == k.shape == dv.shape


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SHAPES[4],
                                   EMPTY[0]])
def test_function_on_cpu_tensors_end_to_end(shape):
    """``ops.flash_attention`` under grad: a ``FlashAttention`` node whose
    backward is ``flash_attention_bwd`` (the plain version on the CPU),
    equal to autograd of the plain forward; without grad, no node."""
    b, h, hkv, sq, sk, hd, causal, window = shape
    q, k, v, do = _inputs(b, h, hkv, sq, sk, hd, seed=2)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    calls = []
    real = flash_attention_bwd

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    import repro_torch.kernels.flash_attention as fa
    fa.flash_attention_bwd = spy
    try:
        got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    finally:
        fa.flash_attention_bwd = real
    assert calls == [tq.shape]
    want = _plain_grads(q, k, v, do, causal, window)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    with torch.no_grad():
        assert ops.flash_attention(tq, tk, tv, causal=causal,
                                   window=window).grad_fn is None
    with torch.inference_mode():
        assert ops.flash_attention(tq.detach(), tk.detach(), tv.detach(),
                                   causal=causal,
                                   window=window).grad_fn is None


def test_function_in_a_loss_matches_jax():
    """A scalar loss through ``FlashAttention.apply`` on non-contiguous
    (B, S, H, hd) views (sliced from one fused projection), against
    ``jax.grad`` of the JAX attention on the same values."""
    b, s, h, hkv, hd = 2, 40, 4, 2, 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, h + 2 * hkv, hd)).astype(np.float32)
    w = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    q, k, v = tx[:, :, :h], tx[:, :, h:h + hkv], tx[:, :, h + hkv:]
    assert not q.is_contiguous()
    loss = (FlashAttention.apply(q, k, v, True, 0)
            * torch.from_numpy(w)).sum()
    (got,) = torch.autograd.grad(loss, (tx,))

    def jloss(x):
        o = jattention(x[:, :, :h], x[:, :, h:h + hkv], x[:, :, h + hkv:],
                       causal=True)
        return jnp.sum(o * w)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    _close(got.numpy(), want)
    assert math.isfinite(float(loss))
