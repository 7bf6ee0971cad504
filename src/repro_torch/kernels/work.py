"""The model-path kernels' work and their route on meta tensors.

One count serves the dry run (:mod:`repro_torch.launch.dryrun`), which
traces a step on ``device="meta"``, and ``chip_smoke.py``, which sets
each kernel's measured time beside its bound:

- the work formulas, (bytes, FLOPs) of one call: each input read once
  and each output written once, and the operations the kernel does on
  this call's shapes (the visible (query, key) pairs of the mask, the
  chunks of the recurrences);
- :func:`bound_ms`, the larger of those bytes over the H100's memory
  rate and those operations over its peak for their type;
- the workspace each CUDA route allocates for a call
  (:func:`rglru_ws_bytes`, :func:`rglru_bwd_ws_bytes`,
  :func:`mlstm_bwd_ws_bytes`, the sizes the sources' own
  ``*_workspace_*`` functions return);
- :func:`record`, which a wrapper's meta route calls in place of a
  launch: it adds one launch and the call's work, by source, to the
  active :class:`KernelTally`.

A meta tensor asks for the meta route by its device, as a CUDA tensor
asks for the kernel and a CPU tensor for the plain version: the route
launches nothing and allocates the outputs and the workspace that the
CUDA route would allocate for this dtype and head dim, on the meta
device.  No wrapper's launch counter moves on it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

#: H100 SXM HBM3 rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense peaks (NVIDIA data sheet), operations per second: bf16
#: on the tensor cores, float32 on the CUDA cores, and "tf32" on the
#: tensor cores (494.7 TFLOP/s: the data sheet's 989.4 with sparsity,
#: halved), where a float32 kernel of the split-TF32 design runs three
#: TF32 products for each float32 one
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 494.7e12}
#: the H100 SXM's streaming multiprocessors (the attention backward's
#: head split reads it; the meta route has no card to ask)
H100_SMS = 132


def bound_ms(n_bytes: int, flops: int, dtype: str) -> Tuple[float, str]:
    """(bound ms, "bytes" or "operations") of moving ``n_bytes`` and
    doing ``flops`` operations of type ``dtype`` (a ``PEAK_FLOPS`` key)
    on the H100."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through, per flat row: the sum
    over queries q of min(Sk, q + 1) (Sk without the causal mask) less
    max(0, q - window + 1) under a window, at least 0 in all, in closed
    form."""
    if causal:
        m = min(sq, sk)
        total = m * (m + 1) // 2 + (sq - m) * sk
    else:
        total = sq * sk
    if window > 0 and sq > window:
        total -= (sq - window) * (sq - window + 1) // 2
    return max(total, 0)


def attn_fwd_work(b: int, h: int, hkv: int, sq: int, sk: int, hd: int,
                  elt: int, causal: bool, window: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one flash forward call: q, k, v read and the
    output written; 4 hd FLOPs per visible pair and query head (S = q k
    and P v)."""
    n_bytes = elt * (2 * b * sq * h * hd + 2 * b * sk * hkv * hd)
    return n_bytes, 4 * hd * b * h * visible_pairs(sq, sk, causal, window)


def attn_bwd_work(b: int, h: int, hkv: int, sq: int, sk: int, hd: int,
                  elt: int, causal: bool, window: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one flash backward call: q, k, v, o and dO read,
    dq, dk, dv written; 10 hd FLOPs per visible pair and query head (S
    again, dP, dq, dk and dv)."""
    n_bytes = elt * (4 * b * sq * h * hd + 4 * b * sk * hkv * hd)
    return n_bytes, 10 * hd * b * h * visible_pairs(sq, sk, causal, window)


def decode_work(b: int, h: int, hkv: int, hd: int, elt: int,
                valid: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one decode call over ``valid`` cache positions
    summed over the batch rows: q read and the output written, the valid
    K and V rows read, the lengths read; 4 hd FLOPs per valid position
    and query head."""
    n_bytes = elt * (2 * b * h * hd + 2 * valid * hkv * hd) + 4 * b
    return n_bytes, 4 * hd * h * valid


def rglru_work(b: int, s: int, w: int, with_h0: bool) -> Tuple[int, int]:
    """(bytes, FLOPs) of one ``rglru_scan`` call: log_a and b read, h
    written (and h0 read); a multiply and an add per element."""
    return 4 * (3 * b * s * w + (b * w if with_h0 else 0)), 2 * b * s * w


def rglru_bwd_work(b: int, s: int, w: int,
                   with_h0: bool) -> Tuple[int, int]:
    """(bytes, FLOPs) of one ``rglru_scan_bwd`` call: log_a, h and dh
    read, dlog_a and db written (and h0 read, dh0 written); about five
    operations per element."""
    return (4 * (5 * b * s * w + (2 * b * w if with_h0 else 0)),
            5 * b * s * w)


def mlstm_work(bh: int, s: int, hd: int, elt: int, carry_in: bool):
    """(bytes, FLOPs) of one chunkwise mLSTM call: q, k, v read and h
    written in the model dtype, the gates read, the final C and n
    written (and the initial ones read); 4 hd^2 + 4 L hd FLOPs per
    token and head (q C and the C update, the L x L scores and S v)."""
    from repro_torch.kernels.mlstm_kernel import CHUNK
    carry = 4 * bh * (hd * hd + hd)
    n_bytes = (elt * 4 * bh * s * hd + 4 * 2 * bh * s
               + carry * (2 if carry_in else 1))
    return n_bytes, bh * s * (4 * hd * hd + 4 * CHUNK * hd)


def mlstm_bwd_work(bh: int, s: int, hd: int, elt: int, carry_in: bool,
                   final: bool):
    """(bytes, FLOPs) of one mLSTM backward call: q, k, v and dh read and
    dq, dk, dv written in the model dtype, the gates read and their
    gradients written, the initial carry read and its gradient written
    where given, the final carry's gradient read where given; about
    10 hd^2 + 10 L hd FLOPs per token and head."""
    from repro_torch.kernels.mlstm_kernel import CHUNK
    carry = 4 * bh * (hd * hd + hd)
    n_bytes = (elt * 7 * bh * s * hd + 4 * 4 * bh * s
               + carry * ((2 if carry_in else 1) + (1 if final else 0)))
    return n_bytes, bh * s * (10 * hd * hd + 10 * CHUNK * hd)


def mlstm_bwd_stored_bytes(bh: int, s: int, hd: int, source: str) -> int:
    """Bytes a backward design writes to its workspace and reads back
    once: the tensor-core designs' dC' of every chunk (bf16 in the bf16
    design, float32 in the float32 one) and u, y and the chunk-internal dk
    in float32; the first design's chunk-start states in float32
    (overwritten by dC' and read again)."""
    from repro_torch.kernels import mlstm_kernel as mk
    nc = -(-s // mk.CHUNK)
    rows = 3 * 4 * bh * nc * mk.CHUNK * hd
    if source == mk.BWD_SM90:
        return 2 * (2 * bh * nc * hd * hd + rows)
    if source == mk.BWD_TF32X3:
        return 2 * (4 * bh * nc * hd * hd + rows)
    return 2 * 4 * bh * nc * hd * hd


# ---------------------------------------------------------------------------
# Workspaces: the bytes each source's own size function returns
# ---------------------------------------------------------------------------


def rglru_ws_bytes(bsz: int, s: int, w: int, chunk: int,
                   tile_w: int) -> int:
    """``rglru_scan_workspace_bytes`` of ``csrc/rglru_scan.cu``: the
    chunks' flags, rounded to 4 ints, then a carry of ``tile_w`` floats
    for every flag but the first."""
    if min(bsz, s, w, chunk) <= 0:
        return 0
    flags = 1 + (-(-s // chunk) - 1) * bsz * -(-w // tile_w)
    return 4 * (((flags + 3) & ~3) + (flags - 1) * tile_w)


def rglru_bwd_ws_bytes(bsz: int, s: int, w: int, chunk: int,
                       tile_w: int) -> int:
    """``rglru_scan_bwd_workspace_bytes`` of ``csrc/rglru_scan_bwd.cu``:
    16 bytes of counters, then a 64-bit carry word per channel of every
    chunk but the last."""
    if min(bsz, s, w, chunk) <= 0:
        return 0
    words = (-(-s // chunk) - 1) * bsz * -(-w // tile_w) * tile_w
    return 16 + 8 * words


def _parts(sizes, align: int) -> int:
    return sum(-(-n // align) * align for n in sizes)


def mlstm_bwd_ws_bytes(source: str, bh: int, s: int, hd: int) -> int:
    """The workspace bytes of an mLSTM backward call on tail-padded S (a
    multiple of the chunk L): ``ws_layout`` of the source, parts
    aligned to 256 bytes (tensor-core designs) or 16 bytes (float32
    parts of the first design)."""
    from repro_torch.kernels import mlstm_kernel as mk
    L, rec, be = mk.CHUNK, 8, 32
    if min(bh, s, hd) <= 0 or s % L:
        return 0
    nc = s // L
    ncb = bh * nc
    if source == mk.BWD_CUDA_CORES:
        n_b = -(-hd // 64)
        floats = [ncb * hd * hd, ncb * hd, ncb * hd, bh * s * hd,
                  bh * s * hd, bh * s * hd, ncb * n_b * L, bh * s * 4,
                  ncb * n_b * L, ncb * n_b]
        return 4 * _parts(floats, 4)
    n_db = -(-hd // be)
    sizes = [4 * ncb * rec * L, 4 * ncb * L * L, 4 * ncb * L * L,
             4 * ncb * hd, 4 * ncb * hd, 4 * ncb * hd * L, 4 * bh * s * hd,
             4 * bh * s * hd, 4 * ncb * hd, 4 * ncb * n_db * L,
             4 * ncb * n_db * L, 4 * ncb * n_db, 4 * ncb * 2 * L]
    if source == mk.BWD_SM90:
        sizes += [2 * ncb * L * L, 2 * ncb * hd * hd]
    else:
        sizes += [4 * ncb * hd * hd]
    return _parts(sizes, 256)


# ---------------------------------------------------------------------------
# The meta route's tally
# ---------------------------------------------------------------------------

#: the active tally, or None
_ACTIVE: Optional["KernelTally"] = None


class KernelTally:
    """Launches, FLOPs and bytes of the meta route's calls, by source,
    while active (``with KernelTally() as t:``); one is active at a
    time."""

    def __init__(self):
        self.by_source: Dict[str, Dict[str, int]] = {}

    def add(self, source: str, flops: int, n_bytes: int) -> None:
        row = self.by_source.setdefault(
            source, {"launches": 0, "flops": 0, "bytes": 0})
        row["launches"] += 1
        row["flops"] += int(flops)
        row["bytes"] += int(n_bytes)

    def launches(self) -> Dict[str, int]:
        return {s: r["launches"] for s, r in sorted(self.by_source.items())}

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a KernelTally is already active")
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return False


def record(source: str, work: Tuple[int, int]) -> None:
    """One call of ``source`` by the meta route, with its (bytes, FLOPs),
    added to the active :class:`KernelTally`, if any."""
    n_bytes, flops = work
    if _ACTIVE is not None:
        _ACTIVE.add(source, flops, n_bytes)
