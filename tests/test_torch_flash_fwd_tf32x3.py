"""The float32 attention forward kernel's arithmetic, rebuilt in plain
torch.

``csrc/flash_attention_tf32x3.cu`` computes the attention forward in
float32 on the tensor cores.  Each of its two products (S = Q K^T over the
head dim, from zero for each key tile, and P V over a tile's keys) is three
TF32 ``mma.sync`` per k-step of 8 contracted elements, into float32
accumulators, in this order: lo(A) hi(B), hi(A) lo(B), hi(A) hi(B).  The
split is sm90.cuh's ``split_tf32_fast``: hi = x rounded to tf32 as
``cvt.rna.tf32.f32`` rounds it (to nearest, ties away from zero, at 10
mantissa bits), lo = x - hi, which ``mma.sync`` reads with its low 13 bits
dropped (``trunc``).  S is summed from zero KG k-steps at a time (KG = 1
up to head dim 128, 4 above), the groups' sums added in order.  The kernel
walks the key tiles (T = 64 keys at head dims up to 64, 32 above) in order
with the base-2 online softmax of the
scores times scale log2 e: each row's running max m and sum l (l = fmaf(l,
alpha, the tile's sum)), P = 2^(x - m) where the mask lets the key through
and 0 elsewhere, and the tile's P V summed from zero and joined to the
accumulator by one rounded fmaf with the rescale alpha = 2^(m_old - m_new)
folded in; at the end out = O / max(l, 1e-30).  :func:`emulate` repeats
that on the CPU, with the roundings done on the bits.  A tile the kernel
skips (wholly outside the band, or past Sk) leaves m, l and O as they are,
so the emulation walks every tile.

The emulation is held to the plain version (``ref.attention_flat_plain``)
and to the JAX package's Pallas kernel in interpret mode, within the bound
the card checks use (chip_smoke's float32 ``ATTN_TOL``): max abs error
within 1e-4 x max(1, largest |plain value|), and ||got - want|| / ||want||
within 1e-4.  One case records what a single TF32 pass (hi hi alone) gives
at the same shape, and holds only that its error is larger than the
split's.  The route and the wrapper's handling of the tensors (read in
place through their strides, counted under the new source, no fallback
to the plain version) are checked here without a card, through meta
tensors and a recording launcher.
"""
import contextlib
import math
import types

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_flat as pallas_flash
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import attention_flat_plain
from test_torch_flash_bwd_tf32x3 import _errors, _flat, _mask, tf32
from test_torch_mlstm_tf32x3 import trunc

TOL_ABS, TOL_REL_NORM = 1e-4, 1e-4
LOG2E = 1.4426950408889634


def split(x: torch.Tensor):
    """``split_tf32_fast`` as ``mma.sync`` reads its halves."""
    hi = tf32(x)
    return hi, trunc(x - hi)


def mma_acc(acc, a, b, three=True):
    """acc + a @ b over the contracted axis in k-steps of 8, in order, each
    the kernel's three products (``three=False``: hi hi alone), each
    rounded to float32."""
    for k0 in range(0, a.shape[-1], 8):
        ah, al = split(a[..., k0:k0 + 8])
        bh, bl = split(b[..., k0:k0 + 8, :])
        if three:
            acc = acc + al @ bh
            acc = acc + ah @ bl
        acc = acc + ah @ bh
    return acc


def fma(a, b, c):
    """fmaf(a, b, c) on float32 tensors: the product exact, one rounding."""
    return (a.double() * b.double() + c.double()).float()


def tile_keys(hd: int) -> int:
    """T, the keys of a tile, of the kernel's head-dim class."""
    return 64 if hd <= 64 else 32


def s_group(hd: int) -> int:
    """KG, the k-steps of S the kernel sums from zero before they join S,
    of the head-dim class."""
    return 4 if hd > 128 else 1


def emulate(q, k, v, causal, window, three=True):
    """The kernel's arithmetic on flat (BH, S, hd) float32 tensors, query
    row b reading kv row b // (BH / BHkv)."""
    bh, sq, hd = q.shape
    bhkv, sk, _ = k.shape
    qpk = bh // bhkv
    kf = k.repeat_interleave(qpk, dim=0)
    vf = v.repeat_interleave(qpk, dim=0)
    sl2 = torch.tensor(1.0 / math.sqrt(hd) * LOG2E, dtype=torch.float32)
    mask = _mask(sq, sk, causal, window)[None]
    t, kg = tile_keys(hd), s_group(hd)
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, hd))
    for k0 in range(0, sk, t):
        kt, vt = kf[:, k0:k0 + t], vf[:, k0:k0 + t]
        s = torch.zeros((bh, sq, kt.shape[1]))
        for d0 in range(0, hd, 8 * kg):
            d1 = d0 + 8 * kg
            s = s + mma_acc(torch.zeros(s.shape), q[..., d0:d1],
                            kt.transpose(1, 2)[:, d0:d1], three)
        x = torch.where(mask[:, :, k0:k0 + t], s * sl2, torch.tensor(-1e30))
        m_new = torch.maximum(m, x.max(dim=-1, keepdim=True).values)
        p = torch.where(x > -5e29, torch.exp2(x - m_new), 0.0)
        alpha = torch.exp2(m - m_new)
        l = fma(l, alpha, p.sum(dim=-1, keepdim=True))
        part = mma_acc(torch.zeros((bh, sq, hd)), p, vt, three)
        acc = fma(acc, alpha, part)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


def _inputs(b, h, hkv, sq, sk, hd, seed):
    """Flat (B*H, S, hd) float32 inputs from numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, hkv, hd)).astype(np.float32)
            for _ in range(2))
    return tuple(_flat(torch.from_numpy(t)) for t in (q, k, v))


def _case(shape, seed, three=True):
    """(emulated, plain, inputs) at ``shape``."""
    b, h, hkv, sq, sk, hd, causal, window = shape
    q, k, v = _inputs(b, h, hkv, sq, sk, hd, seed)
    got = emulate(q, k, v, causal, window, three)
    want = attention_flat_plain(q, k, v, causal=causal, window=window)
    return got, want, (q, k, v)


def _hold(got, want):
    ((err, rel),) = _errors([got], [want])
    assert err <= TOL_ABS, err
    assert rel <= TOL_REL_NORM, rel


#: (B, H, Hkv, Sq, Sk, hd, causal, window): GQA 4 at hd 128 with a padded
#: tail; MQA at hd 64; hd 8 under a window of 5 (narrower than a tile), B =
#: 2; non-causal cross attention, Sq != Sk; fewer queries than keys under
#: the causal mask (top-left aligned); more queries than keys; hd 256 (16/1
#: heads, MQA) under a window of 5; hd 256 with GQA 4 and Sq < Sk; hd 200
#: (padded to 256) under a window of 40; a window of 50 at hd 128 over
#: several tiles
SHAPES = [(1, 8, 2, 130, 130, 128, True, 0),
          (1, 4, 1, 100, 100, 64, True, 0),
          (2, 4, 2, 70, 70, 8, True, 5),
          (1, 4, 2, 60, 150, 64, False, 0),
          (1, 4, 1, 40, 100, 128, True, 0),
          (1, 4, 2, 150, 60, 64, True, 0),
          (1, 16, 1, 72, 72, 256, True, 5),
          (1, 8, 2, 50, 90, 256, True, 0),
          (1, 4, 2, 100, 100, 200, True, 40),
          (1, 4, 1, 200, 200, 128, True, 50)]


@pytest.mark.parametrize("shape", SHAPES)
def test_split_within_tolerance_of_plain(shape):
    """The kernel's split products and online softmax against the plain
    version (the comparison chip_smoke makes on the card)."""
    got, want, _ = _case(shape, seed=31)
    _hold(got, want)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2], SHAPES[4],
                                   SHAPES[6], SHAPES[8]])
def test_split_within_tolerance_of_jax(shape):
    """The same emulation against the JAX package's Pallas kernel
    (interpret mode), in float32 on the same values."""
    b, h, hkv, sq, sk, hd, causal, window = shape
    got, _, (q, k, v) = _case(shape, seed=32)
    want = pallas_flash(*(t.numpy() for t in (q, k, v)), causal=causal,
                        window=window, interpret=True)
    _hold(got, torch.from_numpy(np.array(want)))


def test_single_tf32_pass_is_worse_than_the_split():
    """hi hi alone (one TF32 product, what mma.sync gives a float32 operand
    rounded once) against the three-product split at qwen3_4b's head dim:
    its error is the larger, by max abs error and by relative norm, and its
    relative norm misses the float32 bound (about 3.4e-4 here, the split
    3.1e-7)."""
    split3, want, _ = _case(SHAPES[0], seed=33)
    single, _, _ = _case(SHAPES[0], seed=33, three=False)
    ((e3, r3),) = _errors([split3], [want])
    ((e1, r1),) = _errors([single], [want])
    assert e1 > e3 and r1 > r3, (e1, e3, r1, r3)
    assert r1 > TOL_REL_NORM, r1


def test_sk_zero_and_rows_that_see_no_key():
    """Sk = 0 gives zeros; under a window of 3 with more queries than keys,
    the rows past every key's window see none and give 0 (m stays -1e30,
    P is 0 there), and nothing is NaN."""
    got, want, _ = _case((1, 4, 2, 20, 0, 16, True, 0), seed=34)
    assert got.shape == want.shape and not got.abs().max()
    got, want, _ = _case((1, 2, 1, 40, 16, 16, True, 3), seed=35)
    assert torch.isfinite(got).all()
    assert not got[:, 18:].abs().max()
    _hold(got, want)


@pytest.mark.parametrize("hd", range(8, 257, 8))
def test_route_names_the_split_tf32_source(hd):
    """Every head dim the wrapper takes: float32 runs the new source, bf16
    the wgmma one; the first design is on no route."""
    assert fa.fwd_source(torch.float32, hd) == fa.FWD_TF32X3
    assert fa.fwd_source(torch.bfloat16, hd) == fa.FWD_SM90
    assert fa.FWD_CUDA_CORES not in (fa.fwd_source(torch.float32, hd),
                                     fa.fwd_source(torch.bfloat16, hd))


def test_route_refuses_what_no_kernel_takes():
    assert fa.fwd_source(torch.float32, 12) is None
    assert fa.fwd_source(torch.float32, 264) is None
    assert fa.fwd_source(torch.float16, 64) is None


def test_source_is_built_and_uses_the_split():
    """The source is in the build list; it runs split TF32 ``mma.sync``
    through sm90.cuh's fast split, stages by ``cp.async``, has the
    wrapper's 64-row blocks, and no atomics.  The first design stays in
    the tree and in the build."""
    assert "flash_attention_tf32x3" in _build.SOURCES
    assert "flash_attention" in _build.SOURCES
    src = (_build.CSRC / fa.FWD_TF32X3).read_text()
    hdr = (_build.CSRC / "sm90.cuh").read_text()
    assert "split_tf32_fast" in hdr
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in hdr
    assert "split4_tf32<SplitFast>" in src and "split_tf32_fast(" in src
    assert "mma_tf32_1688" in src and "cp_async16" in src
    assert "flash_fwd_tf32x3(" in src
    # the emulation's tiles and S groups are the source's
    assert "static constexpr int T = HDT > 64 ? 32 : 64;" in src
    assert "static constexpr int KG = HDT > 128 ? 4 : 1;" in src
    assert all(tile_keys(hd) == (64 if hd <= 64 else 32)
               and s_group(hd) == (4 if hd > 128 else 1)
               for hd in range(8, 257, 8))
    defs = dict(line.split()[1:3] for line in src.splitlines()
                if line.startswith("#define ") and len(line.split()) >= 3)
    assert int(defs["BR"]) == fa.BQ
    assert not any(op in src for op in ("atomicAdd", "atom.", "red."))
    assert "#ifdef" not in src and "#if " not in src
    assert (_build.CSRC / fa.FWD_CUDA_CORES).is_file()


class _Launcher:
    """Stands in for the built launcher: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@contextlib.contextmanager
def _no_card(monkeypatch, launcher):
    """The float32 CUDA path with meta tensors in place of CUDA ones: the
    device check passes and the meta route is off, the launcher is
    ``launcher`` (or the real build, where None), the plain version must
    not be called, and the launch counters are restored after."""
    def plain(*a, **kw):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(fa, "_on_cuda", lambda q, meta=False: None)
    monkeypatch.setattr(fa, "_meta_route", lambda t: False)
    monkeypatch.setattr(fa, "attention_flat_plain", plain)
    monkeypatch.setattr(fa.flash_attention_flat, "launches", 0)
    monkeypatch.setattr(fa.flash_attention_flat, "launches_by_source", {})
    if launcher is not None:
        monkeypatch.setattr(fa, "_lib_tf32x3", lambda: launcher)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda d: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda: types.SimpleNamespace(cuda_stream=0))
    yield


def test_bshd_float32_reads_in_place_through_the_strides(monkeypatch):
    """(B, S, H, hd) views sliced from one fused projection go to the
    launcher with their own strides (no transposing or contiguous copy),
    the output is the (B, Sq, H, hd) tensor it returns, and the launch is
    counted under the new source."""
    b, s, h, hkv, hd = 2, 40, 8, 2, 64
    x = torch.empty((b, s, h + 2 * hkv, hd), device="meta")
    q, k, v = x[:, :, :h], x[:, :, h:h + hkv], x[:, :, h + hkv:]
    launcher = _Launcher()
    with _no_card(monkeypatch, launcher):
        out = fa.flash_attention_bshd(q, k, v, causal=True, window=7)
        assert fa.flash_attention_flat.launches_by_source == {
            fa.FWD_TF32X3: 1}
        assert fa.flash_attention_flat.launches == 1
    (args,) = launcher.calls
    assert out.shape == (b, s, h, hd) and out.is_contiguous()
    strides = list(args[4:16])
    assert strides == [st for t in (q, k, v, out) for st in t.stride()[:3]]
    assert strides[:3] == [s * (h + 2 * hkv) * hd, (h + 2 * hkv) * hd, hd]
    assert list(args[16:23]) == [b, h, hkv, s, s, hd, 1]
    assert args[23] == 7 and args[24] == pytest.approx(1 / math.sqrt(hd))


def test_flat_float32_passes_row_views(monkeypatch):
    """The flat entry passes (BH, S, hd) tensors as (1, S, BH, hd) views,
    the output written through the same view of its (BH, Sq, hd) tensor;
    GQA through BH / BHkv heads."""
    bh, bhkv, sq, sk, hd = 8, 2, 30, 50, 256
    q = torch.empty((bh, sq, hd), device="meta")
    k, v = (torch.empty((bhkv, sk, hd), device="meta") for _ in range(2))
    launcher = _Launcher()
    with _no_card(monkeypatch, launcher):
        out = fa.flash_attention_flat(q, k, v, causal=False)
    (args,) = launcher.calls
    assert out.shape == (bh, sq, hd)
    assert list(args[5:7]) == [hd, sq * hd]              # q: S, then head
    assert list(args[14:16]) == [hd, sq * hd]            # out
    assert list(args[16:23]) == [1, bh, bhkv, sq, sk, hd, 0]


@pytest.mark.parametrize("entry", ["flat", "bshd"])
def test_cuda_float32_call_raises_without_a_card(monkeypatch, entry):
    """With no card and no ``nvcc`` the float32 CUDA path raises at the
    build and never computes the plain version; nothing is counted."""
    if not _nvcc_missing():
        pytest.skip("nvcc found: this checks the machine without one")
    b, s, h, hkv, hd = 1, 16, 4, 2, 32
    if entry == "flat":
        q = torch.empty((b * h, s, hd), device="meta")
        k, v = (torch.empty((b * hkv, s, hd), device="meta")
                for _ in range(2))
        call = fa.flash_attention_flat
    else:
        q = torch.empty((b, s, h, hd), device="meta")
        k, v = (torch.empty((b, s, hkv, hd), device="meta")
                for _ in range(2))
        call = fa.flash_attention_bshd
    with _no_card(monkeypatch, None):
        with pytest.raises(RuntimeError, match="nvcc"):
            call(q, k, v, causal=True)
        assert fa.flash_attention_flat.launches == 0


def _nvcc_missing() -> bool:
    try:
        _build.find_nvcc()
    except RuntimeError:
        return True
    return False
