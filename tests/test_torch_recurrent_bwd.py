"""The gradients of the port's recurrences on the CPU.

``ref.rglru_bwd_plain`` and ``ref.mlstm_chunkwise_bwd_plain`` (the
explicit formulas that the backward kernels ``csrc/rglru_scan_bwd.cu``
and ``csrc/mlstm_kernel_bwd.cu`` compute) against torch autograd of the
forward plain versions (``ref.rglru_plain``,
``mlstm_kernel.mlstm_flat_plain``) and against ``jax.vjp`` of the JAX
package's functions that its models differentiate
(``repro.models.rglru.rglru_scan``, an associative scan, and
``repro.models.xlstm.mlstm_chunkwise``, one chunk or chunks of 512).
The mLSTM cases give an initial (C, n), gradients of the final (C, n),
an ``i_raw`` above the cap (no gradient there) and S off the kernel's
chunk of 64 (a padded tail).  Then the two autograd nodes,
``rglru_scan.RglruScan`` and ``mlstm_kernel.MlstmChunkwise``, end to end
on CPU tensors with their forward launch replaced by the plain version:
what they save, the padding and the gradients they hand back.

Inputs from numpy with a seed, float32.  Tolerance: 1e-4 x max(1,
largest |gradient|): the same function in float32 with sums in another
order (the JAX scans reassociate, the chunks differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rglru import rglru_scan as jrglru_scan
from repro.models.xlstm import mlstm_chunkwise as jmlstm_chunkwise
from repro_torch.kernels import mlstm_kernel, ops, ref
from repro_torch.kernels import rglru_scan as trglru

TOL = 1e-4


def _close(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= TOL * scale, (err, scale)


# ---------------------------------------------------------------- rglru

def _rglru_inputs(b, s, w, with_h0, seed=0):
    rng = np.random.default_rng(seed)
    log_a = (-rng.random((b, s, w)) * 0.5).astype(np.float32)
    bv = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    dh = rng.standard_normal((b, s, w)).astype(np.float32)
    return log_a, bv, h0, dh


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 24, 300])
def test_rglru_bwd_plain_equals_autograd(s, with_h0):
    log_a, bv, h0, dh = (None if x is None else torch.from_numpy(x)
                         for x in _rglru_inputs(2, s, 40, with_h0))
    ins = [t.requires_grad_() for t in (log_a, bv, h0) if t is not None]
    h = ref.rglru_plain(log_a, bv, h0)
    want = torch.autograd.grad(h, ins, dh)
    dla, db, dh0 = ref.rglru_bwd_plain(log_a.detach(), h.detach(),
                                       None if h0 is None else h0.detach(),
                                       dh)
    assert (dh0 is None) == (h0 is None)
    for g, w in zip([dla, db] + ([dh0] if with_h0 else []), want):
        _close(g, w)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 24, 300])
def test_rglru_bwd_plain_equals_jax_vjp(s, with_h0):
    log_a, bv, h0, dh = _rglru_inputs(3, s, 33, with_h0, seed=1)
    if with_h0:
        h, vjp = jax.vjp(jrglru_scan, jnp.asarray(log_a), jnp.asarray(bv),
                         jnp.asarray(h0))
    else:
        h, vjp = jax.vjp(lambda la, b: jrglru_scan(la, b),
                         jnp.asarray(log_a), jnp.asarray(bv))
    want = vjp(jnp.asarray(dh))
    t = {k: None if x is None else torch.from_numpy(x)
         for k, x in zip(("la", "h0", "dh"), (log_a, h0, dh))}
    h_port = ref.rglru_plain(t["la"], torch.from_numpy(bv), t["h0"])
    _close(h_port, np.asarray(h))
    got = ref.rglru_bwd_plain(t["la"], h_port, t["h0"], t["dh"])
    for g, w in zip(got, want):
        _close(g, np.asarray(w))


def test_rglru_scan_bwd_on_the_cpu_is_the_plain_version():
    log_a, bv, h0, dh = (torch.from_numpy(x)
                         for x in _rglru_inputs(2, 70, 16, True, seed=2))
    h = trglru.rglru_scan(log_a, bv, h0)
    before = trglru.rglru_scan_bwd.launches
    got = trglru.rglru_scan_bwd(log_a, h, h0, dh)
    want = ref.rglru_bwd_plain(log_a, h, h0, dh)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert trglru.rglru_scan_bwd.launches == before
    with pytest.raises(ValueError, match="dh"):
        trglru.rglru_scan_bwd(log_a, h, h0, dh[:, 1:].contiguous())


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_autograd_node_end_to_end(monkeypatch, with_h0):
    """``RglruScan`` on CPU tensors, its forward launch replaced by the
    plain version: the gradients of a loss equal autograd through the
    plain version, and h0 gets one only where it was given."""
    monkeypatch.setattr(trglru, "_launch", ref.rglru_plain)
    log_a, bv, h0, dh = (None if x is None else torch.from_numpy(x)
                         for x in _rglru_inputs(2, 90, 24, with_h0, seed=3))
    ins = [t.requires_grad_() for t in (log_a, bv, h0) if t is not None]
    h = trglru.RglruScan.apply(log_a, bv, h0)
    assert type(h.grad_fn).__name__ == "RglruScanBackward"
    got = torch.autograd.grad((h * dh).sum(), ins)
    want = torch.autograd.grad((ref.rglru_plain(log_a, bv, h0) * dh).sum(),
                               ins)
    for g, w in zip(got, want):
        _close(g, w)


def test_rglru_autograd_node_with_a_detached_h0(monkeypatch):
    """A carried state that takes no gradient still enters dlog_a_0 as
    h_{-1}: ``RglruScan`` with h0 not requiring grad gives log_a and b
    the gradients of autograd through the plain version, and none to
    h0."""
    monkeypatch.setattr(trglru, "_launch", ref.rglru_plain)
    log_a, bv, h0, dh = (torch.from_numpy(x)
                         for x in _rglru_inputs(2, 90, 24, True, seed=5))
    ins = [t.requires_grad_() for t in (log_a, bv)]
    h = trglru.RglruScan.apply(log_a, bv, h0)
    got = torch.autograd.grad((h * dh).sum(), ins)
    want = torch.autograd.grad((ref.rglru_plain(log_a, bv, h0) * dh).sum(),
                               ins)
    assert float(want[0][:, 0].abs().max()) > 0
    for g, w in zip(got, want):
        _close(g, w)
    dla, db, dh0 = trglru.rglru_scan_bwd(log_a.detach(), h.detach(), h0, dh,
                                         want_dh0=False)
    assert dh0 is None
    _close(dla, want[0])


# ---------------------------------------------------------------- mLSTM

def _mlstm_inputs(b, h, s, hd, carry, seed=0):
    """(B, S, H, hd) q, k, v, dh; (B, S, H) gates with one i_raw above the
    cap; (B, H, hd, hd) c0, dc and (B, H, hd) n0, dn (zeros without
    ``carry``), all numpy float32."""
    rng = np.random.default_rng(seed)

    def rand(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    q, k, v = (rand(b, s, h, hd, scale=0.5) for _ in range(3))
    i_raw = rand(b, s, h, scale=2.0)
    i_raw[0, s // 2, 0] = ref.I_CAP + 1.5
    f_raw = rand(b, s, h) + 2.0
    dh = rand(b, s, h, hd)
    if carry:
        c0, dc = rand(b, h, hd, hd, scale=0.3), rand(b, h, hd, hd, scale=0.1)
        n0, dn = rand(b, h, hd, scale=0.3), rand(b, h, hd, scale=0.1)
    else:
        c0 = dc = np.zeros((b, h, hd, hd), np.float32)
        n0 = dn = np.zeros((b, h, hd), np.float32)
    return q, k, v, i_raw, f_raw, c0, n0, dh, dc, dn


def _heads_first(x: np.ndarray) -> torch.Tensor:
    """(B, S, H, ...) -> contiguous (B*H, S, ...)."""
    t = torch.from_numpy(x).transpose(1, 2)
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:]).contiguous()


def _batch_heads(x: np.ndarray) -> torch.Tensor:
    """(B, H, ...) -> (B*H, ...)."""
    return torch.from_numpy(x).reshape(-1, *x.shape[2:])


def _plain_grads(inputs, carry=True):
    q, k, v, i_raw, f_raw, c0, n0, dh, dc, dn = inputs
    return ref.mlstm_chunkwise_bwd_plain(
        *(_heads_first(x) for x in (q, k, v, i_raw, f_raw)),
        _batch_heads(c0) if carry else None,
        _batch_heads(n0) if carry else None, _heads_first(dh),
        _batch_heads(dc) if carry else None,
        _batch_heads(dn) if carry else None)


@pytest.mark.parametrize("s,carry", [(24, True), (64, False), (80, True),
                                     (130, False), (200, True)])
def test_mlstm_bwd_plain_equals_autograd(s, carry):
    q, k, v, i_raw, f_raw, c0, n0, dh, dc, dn = inputs = _mlstm_inputs(
        1, 3, s, 12, carry, seed=s)
    ins = [_heads_first(x).requires_grad_() for x in (q, k, v, i_raw, f_raw)]
    states = [_batch_heads(x).requires_grad_() for x in (c0, n0)] \
        if carry else [None, None]
    h, (c, n) = mlstm_kernel.mlstm_flat_plain(*ins, *states)
    outs, cots = [h], [_heads_first(dh)]
    if carry:
        outs += [c, n]
        cots += [_batch_heads(dc), _batch_heads(dn)]
    wrt = ins + (states if carry else [])
    want = torch.autograd.grad(outs, wrt, cots)
    (dq, dk, dv), (di, df), (dc0, dn0) = _plain_grads(inputs, carry)
    got = [dq, dk, dv, di, df] + ([dc0, dn0] if carry else [])
    for g, w in zip(got, want):
        _close(g, w)
    # the capped input gate passes nothing
    i_cap = _heads_first(i_raw) > ref.I_CAP
    assert bool(i_cap.any()) and bool((di[i_cap] == 0).all())


@pytest.mark.parametrize("s", [24, 80, 200])
def test_mlstm_bwd_plain_equals_jax_vjp(s):
    b, h, hd = 2, 2, 16
    inputs = _mlstm_inputs(b, h, s, hd, True, seed=10 + s)
    q, k, v, i_raw, f_raw, c0, n0, dh, dc, dn = inputs
    (hj, (cj, nj)), vjp = jax.vjp(
        jmlstm_chunkwise, *(jnp.asarray(x)
                            for x in (q, k, v, i_raw, f_raw, c0, n0)))
    want = vjp((jnp.asarray(dh), (jnp.asarray(dc), jnp.asarray(dn))))
    (dq, dk, dv), (di, df), (dc0, dn0) = _plain_grads(inputs)

    def unflat(t):                       # (B*H, S, ...) -> (B, S, H, ...)
        t = t.reshape(b, h, *t.shape[1:])
        return t.transpose(1, 2)
    for g, w in zip([unflat(dq), unflat(dk), unflat(dv), unflat(di),
                     unflat(df), dc0.reshape(b, h, hd, hd),
                     dn0.reshape(b, h, hd)], want):
        _close(g, np.asarray(w))


def test_mlstm_bwd_on_the_cpu_is_the_plain_version():
    inputs = _mlstm_inputs(1, 2, 70, 8, True, seed=4)
    q, k, v, i_raw, f_raw, c0, n0, dh, dc, dn = inputs
    flat = [_heads_first(x) for x in (q, k, v, i_raw, f_raw)]
    states = [_batch_heads(x) for x in (c0, n0)]
    before = mlstm_kernel.mlstm_chunkwise_bwd.launches
    got = mlstm_kernel.mlstm_chunkwise_bwd(
        *flat, *states, _heads_first(dh), _batch_heads(dc), _batch_heads(dn))
    want = _plain_grads(inputs)
    for g, w in zip(got, want):
        assert all(torch.equal(a, c) for a, c in zip(g, w))
    assert mlstm_kernel.mlstm_chunkwise_bwd.launches == before
    with pytest.raises(ValueError, match="dc"):
        mlstm_kernel.mlstm_chunkwise_bwd(*flat, *states, _heads_first(dh),
                                         _batch_heads(dc)[:, 1:])


@pytest.mark.parametrize("s,carry,use_final", [(70, True, True),
                                               (64, False, False),
                                               (130, True, False)])
def test_mlstm_autograd_node_end_to_end(monkeypatch, s, carry, use_final):
    """``MlstmChunkwise`` on CPU tensors, its forward launch replaced by
    the plain version at the padded length: the gradients of a loss equal
    autograd through ``mlstm_flat_plain``; a final (C, n) the loss does
    not use, and c0/n0 that were not given, get none."""
    def launch(qp, kp, vp, ip, fp, c0, n0, s):
        h, cn = mlstm_kernel.mlstm_flat_plain(qp, kp, vp, ip, fp, c0, n0)
        return h[:, :s], cn
    monkeypatch.setattr(mlstm_kernel, "_launch", launch)
    q, k, v, i_raw, f_raw, c0, n0, dh, dc, dn = _mlstm_inputs(
        2, 2, s, 8, carry, seed=5)
    ins = [_heads_first(x).requires_grad_() for x in (q, k, v, i_raw, f_raw)]
    states = [_batch_heads(x).requires_grad_() for x in (c0, n0)] \
        if carry else [None, None]
    wrt = ins + (states if carry else [])

    def loss(h, c, n):
        out = (h * _heads_first(dh)).sum()
        if use_final:
            out = out + (c * _batch_heads(dc)).sum() \
                + (n * _batch_heads(dn)).sum()
        return out
    h, c, n = mlstm_kernel.MlstmChunkwise.apply(*ins, *states)
    assert h.shape == ins[0].shape
    got = torch.autograd.grad(loss(h, c, n), wrt)
    hw, (cw, nw) = mlstm_kernel.mlstm_flat_plain(*ins, *states)
    want = torch.autograd.grad(loss(hw, cw, nw), wrt)
    for g, w in zip(got, want):
        _close(g, w)


def test_ops_on_cpu_tensors_differentiate_the_plain_versions():
    """On the CPU, ``ops.rglru`` and ``ops.mlstm`` are the plain versions
    under autograd: no node of the kernels' and no launch."""
    log_a, bv, h0, _ = (None if x is None else torch.from_numpy(x)
                        for x in _rglru_inputs(1, 5, 8, True))
    bv.requires_grad_()
    assert "RglruScan" not in type(ops.rglru(log_a, bv, h0).grad_fn).__name__
    q, k, v, i_raw, f_raw = (torch.from_numpy(x).requires_grad_()
                             for x in _mlstm_inputs(1, 1, 8, 4, False)[:5])
    h, _ = ops.mlstm(q, k, v, i_raw, f_raw)
    assert "MlstmChunkwise" not in type(h.grad_fn).__name__
