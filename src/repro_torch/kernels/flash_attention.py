"""Blockwise (flash) attention: the CUDA kernels and their wrappers.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_kernel``, wrapper ``flash_attention_flat``): causal and sliding-window
softmax attention, GQA through the kv head ``h // q_per_kv``, key tiles
outside the band skipped, float32 sums and output in q's dtype.  Prefill
runs it once per layer.

Bound on the H100: operations (about 4 hd FLOPs per visible (query, key)
pair and head).  Two kernels, chosen by dtype alone at every head dim the
wrapper takes (:func:`fwd_source`).  Both read q, k, v and write the output
in place through their strides, so the (B, S, H, hd) entry point
:func:`flash_attention_bshd` makes no transposing copy and the flat (BH, S,
hd) one passes its tensors as (1, S, BH, hd) views:

- bfloat16: ``csrc/flash_attention_sm90.cu``, both products on the tensor
  cores (``wgmma``) with the online softmax on the accumulator in
  registers;
- float32: ``csrc/flash_attention_tf32x3.cu``, both products on the tensor
  cores as three TF32 ``mma.sync`` of split operands (hi = x rounded to
  tf32, lo = x - hi: lo hi, hi lo, hi hi), which keeps float32 accuracy for
  the parity runs; tiles staged by ``cp.async`` in a two-slot ring, P kept
  in registers, each key tile's P V summed from zero and joined to the
  output by one rounded ``fmaf``.

``csrc/flash_attention.cu`` (float32 FMAs on the CUDA cores over contiguous
flat tensors) is the float32 forward's first design and on no route:
:func:`_fwd_cuda_cores` launches it for ``tools/flash_fwd_check.py``, which
times it beside the route.

The gradient, bound through :class:`FlashAttention`, a
``torch.autograd.Function`` whose backward calls
:func:`flash_attention_bwd`; two sources, chosen by dtype alone, at every
head dim the forward takes (:func:`bwd_source`; see each source's head
comment):

- bfloat16: ``csrc/flash_attention_bwd_sm90.cu``, every product on the
  tensor cores (``wgmma``) with its tiles loaded by TMA through the
  tensors' strides; above hd 128 a block's two consumers split the
  head-dim columns, and a group's query heads are split over
  :func:`bwd_head_parts` blocks whose float32 partial dk and dv a third
  kernel sums in a fixed order;
- float32: ``csrc/flash_attention_bwd_tf32x3.cu``, every product on the
  tensor cores as three TF32 ``mma.sync`` of split operands (hi = tf32(x),
  lo = tf32(x - hi): lo hi, hi lo, hi hi), which keeps float32 accuracy
  for the parity runs; tiles staged by ``cp.async`` through the tensors'
  strides; above hd 128 the same head split and reduction.

``csrc/flash_attention_bwd.cu`` (float32 FMAs on the CUDA cores, either
dtype) is the first design and on no route: :func:`_bwd_cuda_cores`
launches it for ``tools/flash_bwd_check.py``, which times it beside the
others.  Each is deterministic (dq, then dk and dv), no atomics.
``flash_attention_bwd.source`` names the source of the last call that
launched one, ``flash_attention_bwd.head_parts`` the head parts it
launched with, ``flash_attention_bwd.launches_by_source`` the launching
calls by source.  The (B, S, H, hd) entry point goes through it when grad
mode is on and an input requires grad;
otherwise (serving, under ``torch.inference_mode``) nothing is saved and
the launches are the forward's alone.  The flat entry point has no
gradient and raises on a CUDA tensor under grad rather than detach.

On a CPU tensor the wrappers compute the plain versions
(:func:`repro_torch.kernels.ref.attention_flat_plain`,
:func:`repro_torch.kernels.ref.attention_flat_bwd_plain`); on a CUDA
tensor they launch a kernel or raise.  Both paths check dtypes and
shapes first.  On a meta tensor they take the meta route
(:mod:`repro_torch.kernels.work`): the allocations of the CUDA route,
the launch replaced by :func:`repro_torch.kernels.work.record`.
``flash_attention_flat.launches`` counts the launches of
either forward kernel from either entry point,
``flash_attention_bwd.launches`` the calls that launched either
backward; ``launches_by_source`` on each splits them by source.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.ref import (attention_flat_bwd_plain,
                                     attention_flat_plain)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
DTYPES = (torch.float32, torch.bfloat16)
MAX_HD = 256
BQ = 64                       # query rows per block (the float32 kernels)
BWD_SM90_ROWS = 128           # the bf16 backward's lse/D scratch unit
MAX_GRID_YZ = 65535
ERR_ENCODE = 20000            # csrc/flash_attention_sm90*.cu: + a CUresult
SM90_BWD_MAX_HD = 256         # csrc/flash_attention_bwd_sm90.cu
FWD_SM90 = "flash_attention_sm90.cu"          # bf16
FWD_TF32X3 = "flash_attention_tf32x3.cu"      # float32
FWD_CUDA_CORES = "flash_attention.cu"         # first design, on no route
BWD_SM90 = "flash_attention_bwd_sm90.cu"      # bf16
BWD_TF32X3 = "flash_attention_bwd_tf32x3.cu"  # float32
SM90_BWD_WIDE_HD = 128        # above it: 64-key blocks, heads split
SM90_BWD_WIDE_KEYS = 64       # keys a dk/dv block owns above that


@functools.lru_cache(maxsize=None)
def _lib_cuda_cores():
    """The first design's launcher (float32, CUDA cores), set up once."""
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   ctypes.c_double, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _lib_tf32x3():
    """The float32 tensor-core launcher, set up once; checks that the
    source's query rows a block are the wrapper's grid unit."""
    lib = _build.load("flash_attention_tf32x3")
    lib.flash_attention_tf32x3_rows.restype = _I
    rows = lib.flash_attention_tf32x3_rows()
    if rows != BQ:
        raise RuntimeError(f"csrc/flash_attention_tf32x3.cu has {rows}-row "
                           f"blocks, the wrapper expects {BQ}")
    fn = lib.flash_attention_tf32x3_launch
    fn.argtypes = [_P, _P, _P, _P, *([_L] * 12), *([_I] * 8),
                   ctypes.c_double, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _lib_bf16():
    """The bfloat16 tensor-core launcher, set up once."""
    fn = _build.load("flash_attention_sm90").flash_attention_sm90_launch
    fn.argtypes = [_P, _P, _P, _P, *([_L] * 12), _I, _I, _I, _I, _I, _I,
                   _I, _I, ctypes.c_double, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _lib_bwd():
    """The backward's launcher (both kernels, both dtypes), set up once."""
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [*([_P] * 10), *([_L] * 15), *([_I] * 8), ctypes.c_double,
                   _I, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _lib_bwd_sm90():
    """The bfloat16 tensor-core backward's launcher, set up once; checks
    that the source's unit of the lse and D scratch is the wrapper's."""
    lib = _build.load("flash_attention_bwd_sm90")
    lib.flash_attention_bwd_sm90_rows.restype = _I
    rows = lib.flash_attention_bwd_sm90_rows()
    if rows != BWD_SM90_ROWS:
        raise RuntimeError(f"csrc/flash_attention_bwd_sm90.cu pads the "
                           f"scratch to {rows} query rows, the wrapper "
                           f"expects {BWD_SM90_ROWS}")
    fn = lib.flash_attention_bwd_sm90_launch
    fn.argtypes = [*([_P] * 11), *([_L] * 24), *([_I] * 10),
                   ctypes.c_double, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _lib_bwd_tf32x3():
    """The float32 tensor-core backward's launcher, set up once; checks
    that the source's keys a dk/dv block are the head split's."""
    lib = _build.load("flash_attention_bwd_tf32x3")
    lib.flash_attention_bwd_tf32x3_rows.restype = _I
    rows = lib.flash_attention_bwd_tf32x3_rows()
    if rows != SM90_BWD_WIDE_KEYS:
        raise RuntimeError(f"csrc/flash_attention_bwd_tf32x3.cu has "
                           f"{rows}-key blocks, the head split expects "
                           f"{SM90_BWD_WIDE_KEYS}")
    fn = lib.flash_attention_bwd_tf32x3_launch
    fn.argtypes = [*([_P] * 11), *([_L] * 15), *([_I] * 9),
                   ctypes.c_double, _P]
    fn.restype = _I
    return fn


def fwd_source(dtype: torch.dtype, hd: int) -> str | None:
    """The source a CUDA call of :func:`flash_attention_flat` or
    :func:`flash_attention_bshd` at this dtype and head dim runs:
    ``flash_attention_sm90.cu`` for bf16, ``flash_attention_tf32x3.cu``
    for float32, at every head dim the wrapper takes (a multiple of 8 up
    to 256); None for a pair no kernel takes (the wrapper's checks refuse
    it first)."""
    if hd % 8 != 0 or not 8 <= hd <= MAX_HD:
        return None
    return {torch.bfloat16: FWD_SM90, torch.float32: FWD_TF32X3}.get(dtype)


def bwd_source(dtype: torch.dtype, hd: int) -> str | None:
    """The source a CUDA call of :func:`flash_attention_bwd` at this dtype
    and head dim runs: ``flash_attention_bwd_sm90.cu`` for bf16,
    ``flash_attention_bwd_tf32x3.cu`` for float32, at every head dim the
    forward takes (a multiple of 8 up to 256); None for a pair no kernel
    takes (the wrapper's checks refuse it first)."""
    if hd % 8 != 0 or not 8 <= hd <= SM90_BWD_MAX_HD:
        return None
    return {torch.bfloat16: BWD_SM90, torch.float32: BWD_TF32X3}.get(dtype)


def bwd_head_parts(b: int, h: int, hkv: int, sk: int, hd: int,
                   n_sm: int) -> int:
    """The blocks over which ``csrc/flash_attention_bwd_sm90.cu`` and
    ``csrc/flash_attention_bwd_tf32x3.cu`` split each group's query heads
    for dk and dv (the rule of their head comments; both have 64-key
    blocks above hd 128): 1 up to hd 128 and at Sk = 0; above, with
    ``base`` = Hkv B ceil(Sk / 64) blocks, round(2 ``n_sm`` / base)
    clamped to 1 .. H / Hkv, about two blocks an SM."""
    if hd <= SM90_BWD_WIDE_HD or sk == 0:
        return 1
    base = hkv * b * -(-sk // SM90_BWD_WIDE_KEYS)
    return max(1, min(h // hkv, (2 * n_sm + base // 2) // base))


def check_head_dim(name: str, hd: int) -> None:
    if hd % 8 != 0 or not 8 <= hd <= MAX_HD:
        raise ValueError(f"{name}: head_dim {hd} is not a multiple of 8 "
                         f"in 8..{MAX_HD}")


def _check_common(q, k, v, ndim, layout):
    if q.dim() != ndim or k.dim() != ndim or v.dim() != ndim:
        raise ValueError(f"flash_attention: q, k, v must be {ndim}-D "
                         f"{layout}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype}, expected one "
                        f"of {DTYPES}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if k.shape != v.shape or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    check_head_dim("flash_attention", q.shape[-1])


def _check(q, k, v):
    _check_common(q, k, v, 3, "(BH, S, hd)")
    bh = q.shape[0]
    if k.shape[0] == 0 or bh % k.shape[0] != 0:
        raise ValueError(f"flash_attention: BH={bh} is not a multiple of "
                         f"BHkv={k.shape[0]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")


def _check_bshd(q, k, v):
    _check_common(q, k, v, 4, "(B, S, H, hd)")
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in B")
    h, hkv = q.shape[2], k.shape[2]
    if hkv == 0 or h % hkv != 0:
        raise ValueError(f"flash_attention: H={h} is not a multiple of "
                         f"Hkv={hkv}")


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q (BH, Sq, hd); k/v (BHkv, Sk, hd), BH % BHkv == 0, contiguous ->
    (BH, Sq, hd) in q's dtype (float32 or bfloat16; hd a multiple of 8 up
    to 256).  Query row b reads kv row b // (BH / BHkv)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_flat_plain(q, k, v, causal=causal, window=window)
    _on_cuda(q, meta=True)
    if _build.grad_wanted(q, k, v):
        raise NotImplementedError(
            "flash_attention_flat has no gradient on the card; call the "
            "(B, S, H, hd) entry point (ops.flash_attention), whose "
            "backward is flash_attention_bwd")
    out = torch.empty_like(q)

    def rows(t):                        # (BH, S, hd) as (1, S, BH, hd)
        return _aligned(t.transpose(0, 1).unsqueeze(0))
    _launch(rows(q), rows(k), rows(v), out.transpose(0, 1).unsqueeze(0),
            causal, window)
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Sk, Hkv, hd), H % Hkv == 0 -> (B, Sq, H,
    hd) in q's dtype; query head h reads kv head h // (H / Hkv).

    On the card both kernels read the tensors in place through their
    strides and write the output directly.  They copy 16 bytes at a time,
    so a tensor whose innermost stride is not 1, whose other strides are
    not multiples of 16 bytes or whose base is not 16-byte aligned is
    first copied to a contiguous one (a (B, S, H, hd) view of a
    projection's output needs none).  The CPU's plain version takes flat
    (B*H, S, hd) copies.

    Under grad with an input that requires it, the call goes through
    :class:`FlashAttention`, whose backward is :func:`flash_attention_bwd`."""
    _check_bshd(q, k, v)
    if _build.grad_wanted(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)
    if q.device.type != "cpu":
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        _launch(_aligned(q), _aligned(k), _aligned(v), out, causal, window)
        return out
    b, s, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * hkv, sk, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * hkv, sk, hd).contiguous()
    of = flash_attention_flat(qf, kf, vf, causal=causal, window=window)
    return of.reshape(b, h, s, hd).transpose(1, 2)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if a kernel that copies 16 bytes at a time (TMA,
    ``cp.async``) can read it in place, else a contiguous copy."""
    per = 16 // t.element_size()
    ok = (t.stride(3) == 1
          and all(t.stride(i) > 0 and t.stride(i) % per == 0
                  for i in range(3))
          and t.data_ptr() % 16 == 0)
    return t if ok else t.clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (the head split's rule); on
    the meta device, the H100's."""
    if device.type == "meta":
        return work.H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _meta_route(t: torch.Tensor) -> bool:
    """Whether a call on ``t`` takes the meta route: ``t`` is on the meta
    device."""
    return t.device.type == "meta"


def _on_cuda(q, meta: bool = False):
    """Raise unless ``q`` is on the card (or, where ``meta``, on the
    meta device, whose route launches nothing)."""
    if q.device.type != "cuda" and not (meta and _meta_route(q)):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")


def _meta_fwd(source, q, k, out, causal, window):
    """The meta route of a forward call that would launch: the output is
    allocated; the call's work goes to the active tallies."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    work.record(source, work.attn_fwd_work(b, h, hkv, sq, sk, hd,
                                           q.element_size(), causal,
                                           window))
    return out


def _launch_bf16(q, k, v, out, causal, window):
    """The tensor-core kernel on (B, S, H, hd) views of aligned tensors."""
    _on_cuda(q, meta=True)
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if h > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"flash_attention: B={b}, H={h} exceed the launch "
                         f"grid")
    if sq == 0 or b == 0:
        return out
    if sk == 0:                         # no key is visible: zeros
        return out.zero_()
    if _meta_route(q):
        return _meta_fwd(FWD_SM90, q, k, out, causal, window)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib_bf16()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), *strides, b, h, hkv, sq, sk, hd,
                          int(causal), int(window), 1.0 / math.sqrt(hd),
                          stream)
    if err != 0:
        what = (f"tensor map refused, CUresult {err - ERR_ENCODE}"
                if err >= ERR_ENCODE else f"CUDA error {err}")
        raise RuntimeError(f"flash_attention kernel launch failed: {what}")
    _count_fwd(FWD_SM90)
    return out


def _launch_tf32x3(q, k, v, out, causal, window):
    """``csrc/flash_attention_tf32x3.cu`` on (B, S, H, hd) views of
    aligned float32 tensors, the output written through its strides."""
    _on_cuda(q, meta=True)
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if -(-sq // BQ) > MAX_GRID_YZ or b * h > 2 ** 31 - 1:
        raise ValueError(f"flash_attention: B={b}, H={h}, Sq={sq} exceed "
                         f"the launch grid")
    if sq == 0 or b == 0:
        return out
    if _meta_route(q):
        return _meta_fwd(FWD_TF32X3, q, k, out, causal, window)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    launch = _lib_tf32x3()              # built at first use, or raises
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), *strides, b, h, hkv, sq, sk, hd,
                     int(causal), int(window), 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(flash_attention_tf32x3.cu): CUDA error {err}")
    _count_fwd(FWD_TF32X3)
    return out


def _launch(q, k, v, out, causal, window):
    """The kernel of the source :func:`fwd_source` names, on (B, S, H, hd)
    views (the checks have refused every dtype and head dim it does not
    name)."""
    launch = {FWD_SM90: _launch_bf16, FWD_TF32X3: _launch_tf32x3}[
        fwd_source(q.dtype, q.shape[-1])]
    return launch(q, k, v, out, causal, window)


def _fwd_cuda_cores(q, k, v, causal, window) -> torch.Tensor:
    """``csrc/flash_attention.cu``, the float32 forward's first design, on
    contiguous flat (BH, S, hd) float32 tensors; on no route of the
    wrappers and not counted: ``tools/flash_fwd_check.py`` times it."""
    _check(q, k, v)
    _on_cuda(q)
    bh, sq, hd = q.shape
    bhkv, sk, _ = k.shape
    if q.dtype != torch.float32 or -(-sq // BQ) > MAX_GRID_YZ:
        raise ValueError("flash_attention.cu takes float32, Sq within the "
                         "launch grid")
    out = torch.empty_like(q)
    if sq == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib_cuda_cores()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), bh, bhkv, sq, sk, hd,
                                int(causal), int(window), 1.0 / math.sqrt(hd),
                                stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(flash_attention.cu): CUDA error {err}")
    return out


def _count_fwd(source: str) -> None:
    flash_attention_flat.launches += 1
    by_source = flash_attention_flat.launches_by_source
    by_source[source] = by_source.get(source, 0) + 1


flash_attention_flat.launches = 0
flash_attention_flat.launches_by_source = {}


class FlashAttention(torch.autograd.Function):
    """(B, S, H, hd) attention with its gradient: forward through
    :func:`flash_attention_bshd` (the forward kernels, or the plain version
    on the CPU), backward through :func:`flash_attention_bwd`.  Saves q, k,
    v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o = flash_attention_bshd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0):
    """The gradient of :func:`flash_attention_bshd`: q, o and do (B, Sq, H,
    hd); k/v (B, Sk, Hkv, hd) -> (dq, dk, dv), each in the inputs' dtype
    and shape; o is the forward's output and do the gradient of the loss
    with respect to it.  dk and dv sum over the query heads of their
    group; Sk = 0 gives dq = 0.

    On CPU tensors: :func:`repro_torch.kernels.ref.attention_flat_bwd_plain`
    on flat copies.  On CUDA tensors, the source :func:`bwd_source` names,
    through the tensors' strides (a tensor that the kernel's 16-byte
    copies cannot read in place is first copied, as the forward does):
    ``csrc/flash_attention_bwd_sm90.cu`` for bfloat16,
    ``csrc/flash_attention_bwd_tf32x3.cu`` for float32; or raise.  On
    meta tensors, the same allocations and no launch (the meta route)."""
    _check_bshd(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, q {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        def flat(t):
            return t.transpose(1, 2).reshape(b * t.shape[2], t.shape[1], hd)
        dq, dk, dv = attention_flat_bwd_plain(
            flat(q), flat(k), flat(v), flat(o), flat(do), causal=causal,
            window=window)
        return (dq.reshape(b, h, sq, hd).transpose(1, 2),
                dk.reshape(b, hkv, sk, hd).transpose(1, 2),
                dv.reshape(b, hkv, sk, hd).transpose(1, 2))
    _on_cuda(q, meta=True)
    if h > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"flash_attention_bwd: B={b}, H={h} exceed the "
                         f"launch grid")
    dq = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, hkv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if b == 0:
        return dq, dk, dv
    source = bwd_source(q.dtype, hd)
    launch = _bwd_sm90 if source == BWD_SM90 else _bwd_tf32x3
    parts = launch(q, k, v, o, do, dq, dk, dv, causal, window)
    if parts and _meta_route(q):
        work.record(source, work.attn_bwd_work(b, h, hkv, sq, sk, hd,
                                               q.element_size(), causal,
                                               window))
    elif parts:
        flash_attention_bwd.launches += 1
        flash_attention_bwd.source = source
        flash_attention_bwd.head_parts = parts
        by_source = flash_attention_bwd.launches_by_source
        by_source[source] = by_source.get(source, 0) + 1
    return dq, dk, dv


def _bwd_sm90(q, k, v, o, do, dq, dk, dv, causal, window,
              parts: int | None = None) -> int:
    """``csrc/flash_attention_bwd_sm90.cu`` into dq, dk, dv (bf16, hd a
    multiple of 8 up to 256); returns the head parts it launched with
    (``parts``, or :func:`bwd_head_parts`' where None), 0 where there
    was nothing to launch.  Above hd 128 with the heads split, the
    float32 partials of dk and dv go to a workspace allocated here for
    the call."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if sq == 0 and sk == 0:
        return 0
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    sq_pad = -(-sq // BWD_SM90_ROWS) * BWD_SM90_ROWS
    lse = torch.empty((b, h, sq_pad), dtype=torch.float32, device=q.device)
    dsum = torch.empty_like(lse)
    if parts is None:
        parts = bwd_head_parts(b, h, hkv, sk, hd, _sm_count(q.device))
    ws = torch.empty((2 * parts * b * sk * hkv * hd if parts > 1 else 0,),
                     dtype=torch.float32, device=q.device)
    if _meta_route(q):         # the meta route: no launch
        return parts
    strides = [st for t in (q, k, v, o, do, dq, dk, dv)
               for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib_bwd_sm90()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), ws.data_ptr() if parts > 1
            else None, *strides, b, h, hkv, sq, sq_pad, sk, hd, int(causal),
            int(window), parts, 1.0 / math.sqrt(hd), stream)
    if err != 0:
        what = (f"tensor map refused, CUresult {err - ERR_ENCODE}"
                if err >= ERR_ENCODE else f"CUDA error {err}")
        raise RuntimeError(f"flash_attention_bwd kernel launch failed "
                           f"(flash_attention_bwd_sm90.cu): {what}")
    return parts


def _bwd_tf32x3(q, k, v, o, do, dq, dk, dv, causal, window) -> int:
    """``csrc/flash_attention_bwd_tf32x3.cu`` into dq, dk, dv (float32,
    hd a multiple of 8 up to 256); returns the head parts it launched with
    (:func:`bwd_head_parts`'), 0 where there was nothing to launch.  With
    the heads split, the float32 partials of dk and dv go to a workspace
    allocated here for the call."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if sq == 0 and sk == 0:
        return 0
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dsum = torch.empty_like(lse)
    parts = bwd_head_parts(b, h, hkv, sk, hd, _sm_count(q.device))
    ws = torch.empty((2 * parts * b * sk * hkv * hd if parts > 1 else 0,),
                     dtype=torch.float32, device=q.device)
    if _meta_route(q):         # the meta route: no launch
        return parts
    strides = [st for t in (q, k, v, o, do) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib_bwd_tf32x3()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), ws.data_ptr() if parts > 1
            else None, *strides, b, h, hkv, sq, sk, hd, int(causal),
            int(window), parts, 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed "
                           f"(flash_attention_bwd_tf32x3.cu): CUDA error "
                           f"{err}")
    return parts


def _bwd_cuda_cores(q, k, v, o, do, dq, dk, dv, causal, window) -> bool:
    """``csrc/flash_attention_bwd.cu``, the first design, into contiguous
    dq, dk, dv (either dtype, any head dim the forward takes); on no route
    of :func:`flash_attention_bwd`: ``tools/flash_bwd_check.py`` times
    it."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    q, k, v, o, do = (t if t.stride(-1) == 1 else t.contiguous()
                      for t in (q, k, v, o, do))
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dsum = torch.empty_like(lse)
    strides = [st for t in (q, k, v, o, do) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib_bwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), do.data_ptr(), dq.data_ptr(),
                         dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                         dsum.data_ptr(), *strides, b, h, hkv, sq, sk, hd,
                         int(causal), int(window), 1.0 / math.sqrt(hd),
                         int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed "
            f"(flash_attention_bwd.cu): CUDA error {err}")
    return True


flash_attention_bwd.launches = 0
flash_attention_bwd.source = None
flash_attention_bwd.head_parts = None
flash_attention_bwd.launches_by_source = {}
