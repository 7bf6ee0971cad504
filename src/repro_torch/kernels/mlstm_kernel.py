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

Three sources, chosen by dtype and head dim only (:func:`fwd_source`):

- bf16 with hd a multiple of 8 up to ``SM90_MAX_HD`` = 2,816 runs
  ``csrc/mlstm_kernel_sm90.cu``: every product on the tensor cores
  (``mma.sync`` bf16 -> fp32), each column block's slab of C held in
  shared memory for the whole walk over the chunks, q and k brought by
  TMA, and the gated factor of the carry update split into two bf16
  parts so that C keeps float32 accuracy (see the source note, and
  tests/test_torch_mlstm_split.py);
- float32 with hd a multiple of 8 up to ``TF32X3_MAX_HD`` = 1,216 runs
  ``csrc/mlstm_kernel_tf32x3.cu``: the same three passes with every
  product on the tensor cores as three TF32 ``mma.sync`` of operands
  split into hi and lo parts, C held in float32 in shared memory, each
  chunk's carry update summed from zero and joined by one rounded
  ``fmaf`` (see its source note, and tests/test_torch_mlstm_tf32x3.py);
- every other head dim, in either dtype, runs the first design,
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

The gradient, bound through :class:`MlstmChunkwise`, a
``torch.autograd.Function`` around either forward route that saves only
its inputs, is :func:`mlstm_chunkwise_bwd`, three sources chosen by dtype
and head dim only (:func:`bwd_source`):

- bf16 with hd a multiple of 8 up to ``SM90_BWD_MAX_HD`` = 1,152 runs
  ``csrc/mlstm_kernel_bwd_sm90.cu``: every product on the tensor cores
  (``mma.sync`` bf16 -> fp32), a reverse walk over dC and a forward walk
  over C, each block's slab of the state in shared memory for the whole
  walk, each chunk's dC' stored in bf16 for the products that follow,
  and both carries' gated factors split into two bf16 parts (see its
  source note, and tests/test_torch_mlstm_bwd_split.py);
- float32 with hd a multiple of 8 up to ``TF32X3_BWD_MAX_HD`` = 1,024
  runs ``csrc/mlstm_kernel_bwd_tf32x3.cu``: the same six-kernel structure
  with every product on the tensor cores as three TF32 ``mma.sync`` of
  operands split into hi and lo parts, C and each chunk's dC' kept in
  float32, each chunk's carry update summed from zero and joined by one
  rounded ``fmaf`` (see its source note, and
  tests/test_torch_mlstm_bwd_tf32x3.py);
- every other head dim, in either dtype, runs the first design,
  ``csrc/mlstm_kernel_bwd.cu``: float32 sums on the CUDA cores, the
  chunk-start states rebuilt into the workspace.

Each allocates its workspace for the call.  The JAX package
differentiates its jnp chunkwise form; it has no backward Pallas kernel.
A call on CUDA tensors goes through it when grad mode is on and an input
requires grad; otherwise (serving) nothing is saved.

On a CPU tensor the wrappers compute the plain versions at the kernel's
chunk (:func:`mlstm_flat_plain`, over
:func:`repro_torch.kernels.ref.mlstm_chunkwise_plain`, through which
autograd runs; and :func:`repro_torch.kernels.ref.mlstm_chunkwise_bwd_plain`);
on a CUDA tensor they launch a kernel or raise; on a meta tensor they
take the meta route (:mod:`repro_torch.kernels.work`: the CUDA route's
allocations, no launch).  Both paths check dtypes and shapes first.  ``mlstm_chunkwise.launches`` and
``mlstm_chunkwise_bwd.launches`` count launches,
``mlstm_chunkwise.source`` and ``mlstm_chunkwise_bwd.source`` name the
source of the last one, and ``.launches_by_source`` on each counts its
launches by source.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.ref import (MLSTM_KERNEL_CHUNK, PAD_GATE,
                                     mlstm_chunkwise_bwd_plain,
                                     mlstm_chunkwise_plain, pad_tail)

_P = ctypes.c_void_p
_I = ctypes.c_int
DTYPES = (torch.float32, torch.bfloat16)
CHUNK = MLSTM_KERNEL_CHUNK     # L in csrc/mlstm_kernel*.cu
MAX_HD = 8192
SM90_MAX_HD = 2816            # mlstm_sm90_max_hd() in csrc/mlstm_kernel_sm90.cu
#: mlstm_tf32x3_max_hd() in csrc/mlstm_kernel_tf32x3.cu
TF32X3_MAX_HD = 1216
#: mlstm_bwd_sm90_max_hd() in csrc/mlstm_kernel_bwd_sm90.cu
SM90_BWD_MAX_HD = 1152
#: mlstm_bwd_tf32x3_max_hd() in csrc/mlstm_kernel_bwd_tf32x3.cu
TF32X3_BWD_MAX_HD = 1024
FWD_SM90 = "mlstm_kernel_sm90.cu"            # bf16
FWD_TF32X3 = "mlstm_kernel_tf32x3.cu"        # float32
FWD_CUDA_CORES = "mlstm_kernel.cu"           # every other head dim
BWD_SM90 = "mlstm_kernel_bwd_sm90.cu"        # bf16
BWD_TF32X3 = "mlstm_kernel_bwd_tf32x3.cu"    # float32
BWD_CUDA_CORES = "mlstm_kernel_bwd.cu"       # every other head dim


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


def _checked_lib(source: str, prefix: str, max_hd: int):
    """A tensor-core source's library, once its chunk is checked to be
    ``CHUNK`` and its head-dim limit the one the route table expects;
    returns ``fn(name, argtypes, restype)``, which sets up its C function
    ``<prefix>_<name>``."""
    lib = _build.load(source[:-len(".cu")])

    def fn(name, argtypes, restype):
        f = getattr(lib, f"{prefix}_{name}")
        f.argtypes, f.restype = argtypes, restype
        return f
    chunk_len, limit = (fn(name, [], _I) for name in ("chunk_len", "max_hd"))
    if (chunk_len(), limit()) != (CHUNK, max_hd):
        raise RuntimeError(f"{source}'s chunk and head-dim limit are "
                           f"{chunk_len()}, {limit()}; the wrapper expects "
                           f"{CHUNK}, {max_hd}")
    return fn


#: each tensor-core forward source: the infix of its C functions, its
#: head-dim limit (the source's ``mlstm_<infix>_max_hd()``)
_TENSOR_CORE_FWD = {FWD_SM90: ("sm90", SM90_MAX_HD),
                    FWD_TF32X3: ("tf32x3", TF32X3_MAX_HD)}


@functools.lru_cache(maxsize=None)
def _lib_fwd_tensor_cores(source: str):
    """A tensor-core forward's launcher, set up once."""
    infix, max_hd = _TENSOR_CORE_FWD[source]
    return _checked_lib(source, f"mlstm_{infix}", max_hd)(
        "launch", [_P] * 13 + [_I, _I, _I, ctypes.c_double, _P], _I)


@functools.lru_cache(maxsize=None)
def _lib_bwd():
    """The backward's launcher and workspace-size function, set up once;
    checks that the source's chunk is ``CHUNK``."""
    lib = _build.load("mlstm_kernel_bwd")
    lib.mlstm_bwd_chunk_len.argtypes = []
    lib.mlstm_bwd_chunk_len.restype = _I
    if lib.mlstm_bwd_chunk_len() != CHUNK:
        raise RuntimeError(f"mlstm_kernel_bwd.cu's chunk is "
                           f"{lib.mlstm_bwd_chunk_len()}, the wrapper pads "
                           f"to {CHUNK}")
    ws = lib.mlstm_bwd_workspace_floats
    ws.argtypes = [_I, _I, _I]
    ws.restype = ctypes.c_longlong
    fn = lib.mlstm_chunkwise_bwd_launch
    fn.argtypes = [_P] * 18 + [_I, _I, _I, ctypes.c_double, _I, _P]
    fn.restype = _I
    return fn, ws


#: each tensor-core backward source: the infix of its C functions, its
#: head-dim limit (the source's ``mlstm_bwd_<infix>_max_hd()``)
_TENSOR_CORE_BWD = {BWD_SM90: ("sm90", SM90_BWD_MAX_HD),
                    BWD_TF32X3: ("tf32x3", TF32X3_BWD_MAX_HD)}


@functools.lru_cache(maxsize=None)
def _lib_bwd_tensor_cores(source: str):
    """A tensor-core backward's launcher and workspace-size function, set
    up once."""
    infix, max_hd = _TENSOR_CORE_BWD[source]
    fn = _checked_lib(source, f"mlstm_bwd_{infix}", max_hd)
    return (fn("launch", [_P] * 18 + [_I, _I, _I, ctypes.c_double, _P], _I),
            fn("workspace_bytes", [_I, _I, _I], ctypes.c_longlong))


def fwd_source(dtype: torch.dtype, hd: int) -> str:
    """The source a CUDA call of :func:`mlstm_chunkwise` at this dtype and
    head dim runs: ``mlstm_kernel_sm90.cu`` for bf16 and
    ``mlstm_kernel_tf32x3.cu`` for float32, each at hd a multiple of 8 up
    to its limit; ``mlstm_kernel.cu`` for every other head dim."""
    if hd % 8 == 0:
        if dtype == torch.bfloat16 and hd <= SM90_MAX_HD:
            return FWD_SM90
        if dtype == torch.float32 and hd <= TF32X3_MAX_HD:
            return FWD_TF32X3
    return FWD_CUDA_CORES


def uses_sm90(dtype: torch.dtype, hd: int) -> bool:
    """Whether a CUDA call at this dtype and head dim runs
    ``csrc/mlstm_kernel_sm90.cu``."""
    return fwd_source(dtype, hd) == FWD_SM90


def bwd_source(dtype: torch.dtype, hd: int) -> str:
    """The source a CUDA call of :func:`mlstm_chunkwise_bwd` at this dtype
    and head dim runs: ``mlstm_kernel_bwd_sm90.cu`` for bf16 and
    ``mlstm_kernel_bwd_tf32x3.cu`` for float32, each at hd a multiple of 8
    up to its limit; ``mlstm_kernel_bwd.cu`` for every other head dim."""
    if hd % 8 == 0:
        if dtype == torch.bfloat16 and hd <= SM90_BWD_MAX_HD:
            return BWD_SM90
        if dtype == torch.float32 and hd <= TF32X3_BWD_MAX_HD:
            return BWD_TF32X3
    return BWD_CUDA_CORES


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
    if _build.grad_wanted(q, k, v, i_raw, f_raw, c0, n0):
        h, c, n = MlstmChunkwise.apply(q, k, v, i_raw, f_raw, c0, n0)
        return h, (c, n)
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
    if dev.type not in ("cuda", "meta"):
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
    c = torch.empty((bh, hd, hd), **f32)
    n = torch.empty((bh, hd), **f32)
    source = fwd_source(q.dtype, hd)
    ins = (q, k, v, i_raw, f_raw, c0, n0, c, n, h)
    err = (_fwd_cuda_cores(*ins) if source == FWD_CUDA_CORES
           else _fwd_tensor_cores(source, *ins))
    if err != 0:
        raise RuntimeError(
            f"mlstm_chunkwise kernel launch failed ({source}): CUDA error "
            f"{err}")
    if dev.type == "meta":
        work.record(source, work.mlstm_work(bh, s, hd, q.element_size(),
                                            c0 is not None))
        return h[:, :s], (c, n)
    mlstm_chunkwise.launches += 1
    mlstm_chunkwise.source = source
    by_source = mlstm_chunkwise.launches_by_source
    by_source[source] = by_source.get(source, 0) + 1
    return h[:, :s], (c, n)


def _fwd_cuda_cores(q, k, v, i_raw, f_raw, c0, n0, c, n, h) -> int:
    """``csrc/mlstm_kernel.cu`` on tail-padded contiguous inputs of either
    dtype, into the given outputs (c takes the initial C first); returns
    its error code.  Its scratch is allocated here for the call."""
    bh, sp, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    if c0 is None:
        c.zero_()
    else:
        c.copy_(c0)
    if n0 is None:
        n0 = torch.zeros((bh, hd), **f32)
    sc = torch.empty((bh, sp // CHUNK, CHUNK, CHUNK), **f32)
    den = torch.empty((bh, sp // CHUNK, CHUNK), **f32)
    if q.device.type == "meta":         # the meta route: no launch
        return 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        return _lib()(*(_ptr(t) for t in (q, k, v, i_raw, f_raw, sc, den, n0,
                                          c, n, h)),
                      bh, sp, hd, 1.0 / math.sqrt(hd),
                      int(q.dtype == torch.bfloat16), stream)


def _fwd_tensor_cores(source, q, k, v, i_raw, f_raw, c0, n0, c, n,
                      h) -> int:
    """A tensor-core source (``csrc/mlstm_kernel_sm90.cu``, bf16, or
    ``csrc/mlstm_kernel_tf32x3.cu``, float32) on tail-padded contiguous
    inputs, into the given outputs; returns its error code.  Its scratch
    (S in the inputs' dtype, the gates and sum_j wc_j k_j in float32) is
    allocated here for the call."""
    bh, sp, hd = q.shape
    nc = sp // CHUNK
    f32 = dict(dtype=torch.float32, device=q.device)
    sc = torch.empty((bh, nc, CHUNK, CHUNK), dtype=q.dtype, device=q.device)
    gates = torch.empty((bh, nc, 4, CHUNK), **f32)
    ksum = torch.empty((bh, nc, hd), **f32)
    if q.device.type == "meta":         # the meta route: no launch
        return 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        return _lib_fwd_tensor_cores(source)(
            *(_ptr(t) for t in (q, k, v, i_raw, f_raw, sc, gates, ksum, c0,
                                n0, c, n, h)),
            bh, sp, hd, 1.0 / math.sqrt(hd), stream)


mlstm_chunkwise.launches = 0
mlstm_chunkwise.source = None
mlstm_chunkwise.launches_by_source = {}


class MlstmChunkwise(torch.autograd.Function):
    """:func:`mlstm_chunkwise` on CUDA tensors with its gradient: forward
    through the source :func:`fwd_source` picks, backward through
    :func:`mlstm_chunkwise_bwd`.  Saves the inputs only (the backward
    rebuilds the states); a final (C, n) that the loss does not use gets
    no gradient tensor (zeros to the kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, i_raw, f_raw, c0, n0):
        ctx.set_materialize_grads(False)
        h, (c, n) = _launch(*pad_tail(q, k, v, i_raw, f_raw), c0, n0,
                            q.shape[1])
        ctx.save_for_backward(q, k, v, i_raw, f_raw, c0, n0)
        return h, c, n

    @staticmethod
    def backward(ctx, dh, dc, dn):
        q, k, v, i_raw, f_raw, c0, n0 = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(q)
        (dq, dk, dv), (di, df), (dc0, dn0) = mlstm_chunkwise_bwd(
            q, k, v, i_raw, f_raw, c0, n0, dh, dc, dn)
        want = ctx.needs_input_grad
        return (dq, dk, dv, di, df, dc0 if want[5] else None,
                dn0 if want[6] else None)


def mlstm_chunkwise_bwd(q, k, v, i_raw, f_raw, c0, n0, dh, dc=None,
                        dn=None):
    """The gradient of :func:`mlstm_chunkwise`: its inputs, dh (BH, S,
    hd) in q's dtype and the gradients dc (BH, hd, hd), dn (BH, hd) of
    the final (C, n), float32 or None (zeros) -> ((dq, dk, dv) in q's
    dtype, (di_raw, df_raw) float32, (dc0, dn0) float32).

    On CPU tensors: :func:`repro_torch.kernels.ref.mlstm_chunkwise_bwd_plain`.
    On CUDA tensors: the source :func:`bwd_source` picks, on the
    tail-padded inputs (dh padded with zeros), the padded rows dropped;
    or raise."""
    _check(q, k, v, i_raw, f_raw, c0, n0)
    bh, s, hd = q.shape
    for name, t, dtype, shape in (("dh", dh, q.dtype, (bh, s, hd)),
                                  ("dc", dc, torch.float32, (bh, hd, hd)),
                                  ("dn", dn, torch.float32, (bh, hd))):
        if t is not None and (t.dtype != dtype or t.device != q.device
                              or tuple(t.shape) != shape):
            raise ValueError(f"mlstm_chunkwise_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected {shape} {dtype} on {q.device}")
    if q.device.type == "cpu":
        return mlstm_chunkwise_bwd_plain(q, k, v, i_raw, f_raw, c0, n0, dh,
                                         dc, dn, chunk=CHUNK)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"mlstm_chunkwise_bwd: no kernel for device "
                         f"{q.device}")
    if bh > 65535:
        raise ValueError(f"mlstm_chunkwise_bwd: BH={bh} exceeds the launch "
                         f"grid")
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    dc0 = torch.empty((bh, hd, hd), **f32)
    dn0 = torch.empty((bh, hd), **f32)
    if bh == 0 or s == 0:
        return ((torch.empty_like(q), torch.empty_like(k),
                 torch.empty_like(v)),
                (torch.empty_like(i_raw), torch.empty_like(f_raw)),
                (dc0.copy_(dc) if dc is not None else dc0.zero_(),
                 dn0.copy_(dn) if dn is not None else dn0.zero_()))
    qp, kp, vp, ip, fp = pad_tail(q, k, v, i_raw, f_raw)
    sp = qp.shape[1]
    if sp == s:
        dhp = dh.contiguous()
    else:
        dhp = torch.zeros((bh, sp, hd), dtype=q.dtype, device=dev)
        dhp[:, :s] = dh
    dq, dk, dv = (torch.empty_like(qp) for _ in range(3))
    di, df = torch.empty_like(ip), torch.empty_like(fp)
    dc, dn = (None if t is None else t.contiguous() for t in (dc, dn))
    source = bwd_source(q.dtype, hd)
    ins = (qp, kp, vp, dhp, ip, fp, c0, n0, dc, dn, dq, dk, dv, di, df, dc0,
           dn0)
    err = (_bwd_cuda_cores(*ins) if source == BWD_CUDA_CORES
           else _bwd_tensor_cores(source, *ins))
    if err != 0:
        raise RuntimeError(f"mlstm_chunkwise_bwd kernel launch failed "
                           f"({source}): CUDA error {err}")
    if dev.type == "meta":
        work.record(source, work.mlstm_bwd_work(
            bh, s, hd, q.element_size(), c0 is not None, dc is not None))
        return ((dq[:, :s], dk[:, :s], dv[:, :s]), (di[:, :s], df[:, :s]),
                (dc0, dn0))
    mlstm_chunkwise_bwd.launches += 1
    mlstm_chunkwise_bwd.source = source
    by_source = mlstm_chunkwise_bwd.launches_by_source
    by_source[source] = by_source.get(source, 0) + 1
    return ((dq[:, :s], dk[:, :s], dv[:, :s]), (di[:, :s], df[:, :s]),
            (dc0, dn0))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bwd_cuda_cores(q, k, v, dh, i_raw, f_raw, c0, n0, dc, dn, dq, dk, dv,
                    di, df, dc0, dn0) -> int:
    """``csrc/mlstm_kernel_bwd.cu`` on tail-padded contiguous inputs of
    either dtype, into the given outputs; returns its error code.  Its
    float32 workspace is allocated here for the call."""
    bh, sp, hd = q.shape
    if q.device.type == "meta":         # the meta route: no launch
        torch.empty(work.mlstm_bwd_ws_bytes(BWD_CUDA_CORES, bh, sp, hd) // 4,
                    dtype=torch.float32, device=q.device)
        return 0
    fn, ws_floats = _lib_bwd()
    ws = torch.empty(ws_floats(bh, sp, hd), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        return fn(*(_ptr(t) for t in (q, k, v, dh, i_raw, f_raw, c0, n0, dc,
                                      dn, dq, dk, dv, di, df, dc0, dn0, ws)),
                  bh, sp, hd, 1.0 / math.sqrt(hd),
                  int(q.dtype == torch.bfloat16), stream)


def _bwd_tensor_cores(source, q, k, v, dh, i_raw, f_raw, c0, n0, dc, dn, dq,
                      dk, dv, di, df, dc0, dn0) -> int:
    """A tensor-core source (``csrc/mlstm_kernel_bwd_sm90.cu``, bf16, or
    ``csrc/mlstm_kernel_bwd_tf32x3.cu``, float32) on tail-padded
    contiguous inputs, into the given outputs; returns its error code.
    Its workspace (bytes, in aligned parts) is allocated here for the
    call."""
    bh, sp, hd = q.shape
    if q.device.type == "meta":         # the meta route: no launch
        torch.empty(work.mlstm_bwd_ws_bytes(source, bh, sp, hd),
                    dtype=torch.uint8, device=q.device)
        return 0
    fn, ws_bytes = _lib_bwd_tensor_cores(source)
    ws = torch.empty(ws_bytes(bh, sp, hd), dtype=torch.uint8,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        return fn(*(_ptr(t) for t in (q, k, v, dh, i_raw, f_raw, c0, n0, dc,
                                      dn, dq, dk, dv, di, df, dc0, dn0, ws)),
                  bh, sp, hd, 1.0 / math.sqrt(hd), stream)


mlstm_chunkwise_bwd.launches = 0
mlstm_chunkwise_bwd.source = None
mlstm_chunkwise_bwd.launches_by_source = {}
