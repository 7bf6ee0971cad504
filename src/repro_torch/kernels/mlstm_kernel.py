"""Chunkwise mLSTM: the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/mlstm_kernel.py``
(``_kernel``, wrapper ``mlstm_chunkwise``): the mLSTM matrix memory
``C_t = f_t C_{t-1} + i_t k_t v_t^T`` over flattened (BH, S, hd) heads
in chunks of ``CHUNK`` tokens, with ``i = exp(min(i_raw, 8))`` and
``f = sigmoid(f_raw)``, and ``h = q C / max(|q n|, 1)``.  xlstm's
prefill runs it once per mLSTM layer.  Unlike the TPU kernel, which
starts from a zero carry and keeps its final value in VMEM scratch, it
takes an initial (C, n) and returns the final one: the model's prefill
hands it to decode.

Two kernels, chosen by dtype and head dim only (:func:`uses_sm90`):

- bf16 with hd a multiple of 8 up to ``SM90_MAX_HD`` = 2,816 runs
  ``csrc/mlstm_kernel_sm90.cu``: every product on the tensor cores
  (``mma.sync`` bf16 -> fp32), each column block's slab of C held in
  shared memory for the whole walk over the chunks, q and k brought by
  TMA, and the gated factor of the carry update split into two bf16
  parts so that C keeps float32 accuracy (see the source note, and
  tests/test_torch_mlstm_split.py);
- float32 at any hd, and every other bf16 head dim, run the first design,
  ``csrc/mlstm_kernel.cu``: float32 FMAs on the CUDA cores with C in
  device memory.

Nothing is chosen on failure: a build or launch error raises.  Bound on
the H100: operations (4 hd^2 + 4 L hd FLOPs per token and head).

The kernel's chunk is ``CHUNK`` = 64 (the model's 512 x 512 score
matrix does not fit a block).  Where S is not a multiple of it, the
wrapper pads the tail on both paths with q = k = v = 0, an input gate
of ``exp(-1e30)`` = 0 and a forget gate of ``sigmoid(1e30)`` = 1,
which carry the state through unchanged (large finite values, so no
``inf - inf`` appears), and drops the padded rows of h.

On a CPU tensor the wrapper computes the plain version at the kernel's
chunk (:func:`mlstm_flat_plain`, over
:func:`repro_torch.kernels.ref.mlstm_chunkwise_plain`); on a CUDA
tensor it launches a kernel or raises.  Both paths check dtypes
and shapes first.  ``mlstm_chunkwise.launches`` counts launches and
``mlstm_chunkwise.source`` names the source of the last one.  The
kernels have no backward yet: on a CUDA tensor under grad the wrapper
raises (ROADMAP A8.2) rather than return an output without a gradient.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mlstm_chunkwise_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 64                    # L in csrc/mlstm_kernel{,_sm90}.cu
MAX_HD = 8192
SM90_MAX_HD = 2816            # mlstm_sm90_max_hd() in csrc/mlstm_kernel_sm90.cu
PAD_GATE = 1e30               # i_raw = -PAD_GATE, f_raw = +PAD_GATE


@functools.lru_cache(maxsize=None)
def _lib():
    """The configured launcher, set up once; checks that the source's
    chunk is ``CHUNK``."""
    lib = _build.load("mlstm_kernel")
    lib.mlstm_chunk_len.argtypes = []
    lib.mlstm_chunk_len.restype = _I
    if lib.mlstm_chunk_len() != CHUNK:
        raise RuntimeError(f"mlstm_kernel.cu's chunk is "
                           f"{lib.mlstm_chunk_len()}, the wrapper pads to "
                           f"{CHUNK}")
    fn = lib.mlstm_chunkwise_launch
    fn.argtypes = [_P] * 11 + [_I, _I, _I, ctypes.c_double, _I, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _lib_sm90():
    """The bf16 tensor-core launcher, set up once; checks that the
    source's chunk is ``CHUNK`` and its head-dim limit ``SM90_MAX_HD``."""
    lib = _build.load("mlstm_kernel_sm90")
    for name in ("mlstm_sm90_chunk_len", "mlstm_sm90_max_hd"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = _I
    if (lib.mlstm_sm90_chunk_len(), lib.mlstm_sm90_max_hd()) != (
            CHUNK, SM90_MAX_HD):
        raise RuntimeError(
            f"mlstm_kernel_sm90.cu's chunk and head-dim limit are "
            f"{lib.mlstm_sm90_chunk_len()}, {lib.mlstm_sm90_max_hd()}; the "
            f"wrapper expects {CHUNK}, {SM90_MAX_HD}")
    fn = lib.mlstm_sm90_launch
    fn.argtypes = [_P] * 13 + [_I, _I, _I, ctypes.c_double, _P]
    fn.restype = _I
    return fn


def uses_sm90(dtype: torch.dtype, hd: int) -> bool:
    """Whether a CUDA call at this dtype and head dim runs
    ``csrc/mlstm_kernel_sm90.cu`` (else ``csrc/mlstm_kernel.cu``)."""
    return dtype == torch.bfloat16 and hd % 8 == 0 and hd <= SM90_MAX_HD


def _check(q, k, v, i_raw, f_raw, c0, n0):
    if q.dim() != 3:
        raise ValueError("mlstm_chunkwise: q, k, v must be (BH, S, hd)")
    if q.dtype not in DTYPES:
        raise TypeError(f"mlstm_chunkwise: dtype {q.dtype}, expected one "
                        f"of {DTYPES}")
    bh, s, hd = q.shape
    want = [("k", k, q.dtype, (bh, s, hd)), ("v", v, q.dtype, (bh, s, hd)),
            ("i_raw", i_raw, torch.float32, (bh, s)),
            ("f_raw", f_raw, torch.float32, (bh, s))]
    if c0 is not None:
        want.append(("c0", c0, torch.float32, (bh, hd, hd)))
    if n0 is not None:
        want.append(("n0", n0, torch.float32, (bh, hd)))
    for name, t, dtype, shape in want:
        if t.dtype != dtype:
            raise TypeError(f"mlstm_chunkwise: {name} is {t.dtype}, "
                            f"expected {dtype}")
        if t.device != q.device:
            raise ValueError(f"mlstm_chunkwise: {name} on {t.device}, q on "
                             f"{q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"mlstm_chunkwise: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    for name, t in (("q", q), ("k", k), ("v", v), ("i_raw", i_raw),
                    ("f_raw", f_raw), ("c0", c0), ("n0", n0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"mlstm_chunkwise: {name} is not contiguous")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"mlstm_chunkwise: head_dim {hd} not in "
                         f"1..{MAX_HD}")


def pad_tail(q, k, v, i_raw, f_raw, chunk: int = CHUNK):
    """Pad S up to a multiple of ``chunk`` with steps that leave the
    carry unchanged: q = k = v = 0, i_raw = -1e30 (input gate 0),
    f_raw = +1e30 (forget gate 1).  Returns the five tensors (the
    inputs themselves where S already is a multiple)."""
    s = q.shape[1]
    pad = -s % chunk
    if pad == 0:
        return q, k, v, i_raw, f_raw

    def ext(t, fill):
        tail = torch.full((t.shape[0], pad, *t.shape[2:]), fill,
                          dtype=t.dtype, device=t.device)
        return torch.cat([t, tail], dim=1)
    return (ext(q, 0.0), ext(k, 0.0), ext(v, 0.0), ext(i_raw, -PAD_GATE),
            ext(f_raw, PAD_GATE))


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_raw: torch.Tensor, f_raw: torch.Tensor,
                    c0: Optional[torch.Tensor] = None,
                    n0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """q, k, v (BH, S, hd) float32 or bfloat16; i_raw, f_raw (BH, S)
    float32; c0 (BH, hd, hd), n0 (BH, hd) float32 or None (zeros) ->
    h (BH, S, hd) in q's dtype, (C (BH, hd, hd), n (BH, hd)) float32."""
    _check(q, k, v, i_raw, f_raw, c0, n0)
    if q.device.type == "cpu":
        return mlstm_flat_plain(q, k, v, i_raw, f_raw, c0, n0)
    _build.refuse_grad("mlstm_chunkwise", q, k, v, i_raw, f_raw, c0, n0)
    return _launch(*pad_tail(q, k, v, i_raw, f_raw), c0, n0, q.shape[1])


def mlstm_flat_plain(q, k, v, i_raw, f_raw, c0=None, n0=None):
    """The plain version of the kernel on any device: the same tail
    padding, then :func:`repro_torch.kernels.ref.mlstm_chunkwise_plain`
    at the kernel's chunk over (BH, S, 1, hd) heads."""
    s = q.shape[1]
    qp, kp, vp, ip, fp = pad_tail(q, k, v, i_raw, f_raw)
    h, (c, n) = mlstm_chunkwise_plain(
        qp[:, :, None], kp[:, :, None], vp[:, :, None], ip[:, :, None],
        fp[:, :, None], None if c0 is None else c0[:, None],
        None if n0 is None else n0[:, None], chunk=CHUNK)
    return h[:, :s, 0], (c[:, 0], n[:, 0])


def _launch(q, k, v, i_raw, f_raw, c0, n0, s):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"mlstm_chunkwise: no kernel for device {dev}")
    bh, sp, hd = q.shape
    if bh > 65535:
        raise ValueError(f"mlstm_chunkwise: BH={bh} exceeds the launch grid")
    f32 = dict(dtype=torch.float32, device=dev)
    h = torch.empty_like(q)
    if bh == 0 or sp == 0:
        return h[:, :s], (
            torch.zeros((bh, hd, hd), **f32) if c0 is None else c0.clone(),
            torch.zeros((bh, hd), **f32) if n0 is None else n0.clone())
    n = torch.empty((bh, hd), **f32)
    nc = sp // CHUNK
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if uses_sm90(q.dtype, hd):
            source = "mlstm_kernel_sm90.cu"
            c = torch.empty((bh, hd, hd), **f32)
            sc = torch.empty((bh, nc, CHUNK, CHUNK), dtype=torch.bfloat16,
                             device=dev)
            gates = torch.empty((bh, nc, 4, CHUNK), **f32)
            ksum = torch.empty((bh, nc, hd), **f32)
            err = _lib_sm90()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), i_raw.data_ptr(),
                f_raw.data_ptr(), sc.data_ptr(), gates.data_ptr(),
                ksum.data_ptr(), None if c0 is None else c0.data_ptr(),
                None if n0 is None else n0.data_ptr(), c.data_ptr(),
                n.data_ptr(), h.data_ptr(), bh, sp, hd, 1.0 / math.sqrt(hd),
                stream)
        else:
            source = "mlstm_kernel.cu"
            c = (torch.zeros((bh, hd, hd), **f32) if c0 is None
                 else c0.clone())
            if n0 is None:
                n0 = torch.zeros((bh, hd), **f32)
            sc = torch.empty((bh, nc, CHUNK, CHUNK), **f32)
            den = torch.empty((bh, nc, CHUNK), **f32)
            err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         i_raw.data_ptr(), f_raw.data_ptr(), sc.data_ptr(),
                         den.data_ptr(), n0.data_ptr(), c.data_ptr(),
                         n.data_ptr(), h.data_ptr(), bh, sp, hd,
                         1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
                         stream)
    if err != 0:
        raise RuntimeError(
            f"mlstm_chunkwise kernel launch failed ({source}): CUDA error "
            f"{err}")
    mlstm_chunkwise.launches += 1
    mlstm_chunkwise.source = source
    return h[:, :s], (c, n)


mlstm_chunkwise.launches = 0
mlstm_chunkwise.source = None
