"""The RG-LRU backward kernel's arithmetic, rebuilt on the CPU.

``csrc/rglru_scan_bwd.cu`` runs only on the card.  Its order of operations
is rebuilt here in plain PyTorch (in this file only) and held against the
port's plain version (``ref.rglru_bwd_plain``, a loop over S in reverse)
and against ``jax.vjp`` of the JAX model's ``rglru_scan`` (an associative
scan) on the same numpy inputs:

- chunks of T_c steps, each split into ``warps`` sub-chunks of
  ceil(rows / warps) steps (the last ones short or empty);
- local pass of each sub-chunk from its end with a zero carry:
  g = fma(a_{t+1}, g, dh_t), keeping B_k = a_{r0} g_{r0} and A_k =
  exp(LA_k), LA_k the float32 sum of its log_a from its end (an empty
  sub-chunk gives A = 1, B = 0);
- carry: strictly from the last chunk, x = P_{c+1} (0 past the end) run
  through the sub-chunks last to first, x = fma(A_k, x, B_k), the x
  entering a sub-chunk being its entry carry and the last x P_c;
- output pass of each sub-chunk from its entry carry: g = fma(a_{t+1}, g,
  dh_t) (the first step adds dh to the carry), db = g, dlog_a = (g a_t)
  h_{t-1} with h_{-1} = h0 or 0; chunk 0's first sub-chunk ends with dh0
  = a_0 g_0.

The kernel's ``fmaf`` rounds once; it is rebuilt as the float64 product
(exact for float32 factors) plus the addend, rounded to float32.  Chunks
of the kernel's own (``rglru_scan.BWD_CHUNK`` over ``BWD_WARPS`` warps),
1, and at least S.  Tolerance 1e-4 x max(1, largest |gradient|), the
bound the card holds the kernel to against its plain version
(``chip_smoke.py`` ``ATTN_TOL["float32"]``, ``tests/test_torch_cuda.py``).
Inputs follow ``tests/test_torch_recurrent_bwd.py`` (log_a = -0.5 u, the
rest normal); the strong-decay cases take log_a down to -8, where a
sub-chunk's exp(LA_k) underflows to 0.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rglru import rglru_scan as jrglru_scan
from repro_torch.kernels import rglru_scan as kmod
from repro_torch.kernels.ref import rglru_bwd_plain, rglru_plain

TOL = 1e-4
#: jax.vjp of the JAX model's scan, with and without h0, jitted (one
#: compile per shape, not one per operation)
_VJP = jax.jit(lambda la, b_, h0, g: jax.vjp(jrglru_scan, la, b_, h0)[1](g))
_VJP_NO_H0 = jax.jit(lambda la, b_, g: jax.vjp(
    lambda x, y: jrglru_scan(x, y), la, b_)[1](g))


def _fma(a, x, b):
    return (a.double() * x.double() + b.double()).float()


def spans(rows: int, warps: int):
    """Each warp's sub-chunk [r0, r1) of a chunk of ``rows`` steps."""
    sub = -(-rows // warps)
    out = []
    for k in range(warps):
        r0 = min(rows, k * sub)
        out.append((r0, min(rows, r0 + sub)))
    return out


def chained_bwd(log_a, h, h0, dh, chunk, warps, want_dh0=True):
    """The kernel's arithmetic: (dlog_a, db, dh0) as the kernel gives
    them (dh0 None without h0 or without ``want_dh0``), and every
    sub-chunk's A_k."""
    bsz, s, w = log_a.shape
    a = torch.exp(log_a)
    first = torch.zeros(bsz, w) if h0 is None else h0
    prev = torch.cat([first[:, None], h[:, :-1]], dim=1)
    dla, db = torch.empty(bsz, s, w), torch.empty(bsz, s, w)
    dh0, decays = None, []
    x = torch.zeros(bsz, w)                         # P_{c+1}
    for c in reversed(range(-(-s // chunk))):
        t0 = c * chunk
        parts = spans(min(chunk, s - t0), warps)
        aggs = []
        for r0, r1 in parts:                        # local passes
            g = a_next = la_sum = torch.zeros(bsz, w)
            for t in range(t0 + r1 - 1, t0 + r0 - 1, -1):
                la_sum = la_sum + log_a[:, t]
                g = _fma(a_next, g, dh[:, t])
                a_next = a[:, t]
            aggs.append((torch.exp(la_sum), a_next * g))
        entries = [None] * warps
        for k in reversed(range(warps)):            # the carry
            entries[k] = x
            x = _fma(aggs[k][0], x, aggs[k][1])
        decays += [big_a for big_a, _ in aggs]
        for k, (r0, r1) in enumerate(parts):        # output passes
            g, a_next = entries[k], torch.ones(bsz, w)
            for t in range(t0 + r1 - 1, t0 + r0 - 1, -1):
                g = _fma(a_next, g, dh[:, t])
                db[:, t] = g
                dla[:, t] = g * a[:, t] * prev[:, t]
                a_next = a[:, t]
            if c == 0 and k == 0 and h0 is not None and want_dh0:
                dh0 = a_next * g
    return (dla, db, dh0), decays


def _inputs(b, s, w, with_h0, strong):
    rng = np.random.default_rng(b * 10_000 + s * 10 + w)
    log_a = (-rng.random((b, s, w)) * (8.0 if strong else 0.5)) \
        .astype(np.float32)
    bv = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    dh = rng.standard_normal((b, s, w)).astype(np.float32)
    return log_a, bv, h0, dh


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    assert err <= TOL * scale, (err, scale)


def _config(name, s):
    """(T_c, warps): the kernel's own, 1, or at least S."""
    if name == "kernel":
        return kmod.BWD_CHUNK, kmod.BWD_WARPS
    if name == "one":
        return 1, 1
    return -(-(s + 5) // kmod.BWD_WARPS) * kmod.BWD_WARPS, kmod.BWD_WARPS


#: (B, S, W, with h0, want dh0, strong decay): W not a multiple of 4 (the
#: kernel's 4-byte copies; 37 and 4,099), S not a multiple of the chunk,
#: S a multiple of it, S below one chunk, S = 1, no h0, h0 given but no
#: dh0 wanted (h0 still enters dlog_a_0), strong decay
CASES = [(2, 300, 37, True, True, False), (1, 300, 4099, True, True, False),
         (1, 512, 16, True, True, False), (2, 100, 8, False, True, False),
         (3, 1, 8, True, True, False), (2, 600, 24, False, True, False),
         (2, 300, 40, True, False, False), (2, 600, 24, True, True, True),
         (1, 513, 12, False, True, True)]


@pytest.mark.parametrize("config", ["kernel", "one", "whole"])
@pytest.mark.parametrize("b,s,w,with_h0,want_dh0,strong", CASES)
def test_chained_bwd_vs_plain_and_jax(b, s, w, with_h0, want_dh0, strong,
                                      config):
    chunk, warps = _config(config, s)
    log_a, bv, h0, dh = _inputs(b, s, w, with_h0, strong)
    t_la, t_b, t_dh = (torch.from_numpy(x) for x in (log_a, bv, dh))
    t_h0 = None if h0 is None else torch.from_numpy(h0)
    h = rglru_plain(t_la, t_b, t_h0)
    got, _ = chained_bwd(t_la, h, t_h0, t_dh, chunk, warps, want_dh0)
    assert (got[2] is None) == (h0 is None or not want_dh0)
    want = rglru_bwd_plain(t_la, h, t_h0, t_dh)
    jax_want = (_VJP(*map(jnp.asarray, (log_a, bv, h0, dh))) if with_h0
                else _VJP_NO_H0(*map(jnp.asarray, (log_a, bv, dh))))
    for i, g in enumerate(got):
        if g is None:
            continue
        _close(g.numpy(), want[i].numpy())
        _close(g.numpy(), np.asarray(jax_want[i]))


def test_strong_decay_underflows_a_sub_chunk():
    """The strong-decay inputs reach the case the design must survive: a
    sub-chunk's exp(LA_k) is exactly 0, so its carry out is its own
    B_k."""
    log_a, bv, h0, dh = (torch.from_numpy(x)
                         for x in _inputs(2, 600, 24, True, True))
    _, decays = chained_bwd(log_a, rglru_plain(log_a, bv, h0), h0, dh,
                            kmod.BWD_CHUNK, kmod.BWD_WARPS)
    assert any(bool((d == 0).all()) for d in decays)


def test_spans_cover_each_chunk_once():
    """The sub-chunks of a chunk tile its rows in order: a full chunk in
    equal parts, a short one in parts of ceil(rows / warps), the last ones
    empty where rows are too few."""
    for rows in (1, 3, 64, 127, 128, 255, 256, 512):
        for warps in (1, 2, 4, 8, 16):
            parts = spans(rows, warps)
            assert parts[0][0] == 0 and parts[-1][1] == rows
            assert all(p[1] == q[0] for p, q in zip(parts, parts[1:]))
            assert all(r0 <= r1 for r0, r1 in parts)
    assert spans(256, 4) == [(0, 64), (64, 128), (128, 192), (192, 256)]
    assert spans(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]


def test_plan_bwd_at_the_train_shape():
    """recurrentgemma's train shape (B=4, S=1,024, W=4,096): one block per
    (chunk, batch row, 32 channels), with the T_c, warps and W_t that
    ``csrc/rglru_scan_bwd.cu`` is built for (its ``#define``s), so the
    rebuild above runs the kernel's own split."""
    p = kmod.plan_bwd(4, 1024, 4096)
    chunk, warps = kmod.BWD_CHUNK, kmod.BWD_WARPS
    assert (p["chunk"], p["warps"], p["tile_w"]) == (chunk, warps, 32)
    assert p["n_chunks"] == -(-1024 // chunk)
    assert p["grid"] == p["n_chunks"] * 4 * 128
    src = (pathlib.Path(kmod.__file__).parent / "csrc" /
           "rglru_scan_bwd.cu").read_text()
    defines = dict(re.findall(r"^#define (\w+) (\d+)\b", src, re.M))
    assert {k: int(defines[k]) for k in ("CHUNK", "WARPS", "TILE_W")} == {
        "CHUNK": chunk, "WARPS": warps, "TILE_W": kmod.TILE_W}
