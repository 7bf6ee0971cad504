"""The port's attention entry points against the JAX package on the CPU.

``repro_torch.kernels.ops.flash_attention`` / ``flash_attention_flat``
and ``decode_attention`` run here on CPU tensors, so through their plain
versions (the CUDA kernels are held to those on the card by
``chip_smoke.py``).  The same numpy inputs go through the JAX Pallas
kernels in interpret mode and through ``repro.kernels.ref``, at every
case of ``tests/test_kernels.py``'s attention sections, in float32 and
bfloat16.  Tolerance: ``TOL`` of ``tests/test_kernels.py`` — 2e-5 in
float32 (the same float32 sums taken in another order), 2e-2 in
bfloat16 (one rounding of the output to bfloat16, 2^-8 relative, on
values of order 1).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as kref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention_flat as pallas_flash
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention_flat
from repro_torch.models import attention as tattn

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

FLASH_CASES = [
    (4, 4, 128, 128, 64, True, 0, 64, 64),
    (4, 2, 128, 128, 64, True, 0, 64, 64),      # GQA 2:1
    (8, 2, 96, 96, 32, True, 0, 64, 64),        # padded seq
    (2, 1, 256, 256, 64, True, 64, 64, 64),     # sliding window
    (2, 2, 64, 192, 32, False, 0, 64, 64),      # cross attention
    (6, 3, 128, 128, 128, True, 0, 128, 128),   # MXU-aligned hd
]
DECODE_CASES = [
    (2, 4, 4, 256, 64, 128),
    (2, 8, 2, 256, 64, 128),        # GQA 4:1
    (3, 4, 1, 300, 32, 128),        # MQA + padded seq
    (1, 16, 8, 512, 128, 256),
]


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bh,hkv,sq,sk,hd,causal,window,bq,bk", FLASH_CASES)
def test_flash_attention_flat_vs_jax(bh, hkv, sq, sk, hd, causal, window,
                                     bq, bk, dtype):
    rng = np.random.default_rng(bh * 1000 + sq + hd)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((bh, sq, hd), (hkv, sk, hd), (hkv, sk, hd)))
    before = flash_attention_flat.launches
    got = flash_attention_flat(qt, kt, vt, causal=causal, window=window)
    assert flash_attention_flat.launches == before   # plain version
    assert got.dtype == qt.dtype and got.shape == (bh, sq, hd)
    pallas = pallas_flash(qj, kj, vj, causal=causal, window=window,
                          block_q=bq, block_k=bk, interpret=True)
    ref = kref.attention_flat_ref(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,hkv,s,hd,bs", DECODE_CASES)
def test_decode_attention_vs_jax(b, h, hkv, s, hd, bs, dtype):
    rng = np.random.default_rng(b * 1000 + s + hd)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((b, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    lengths = rng.integers(1, s + 1, size=b).astype(np.int32)
    before = decode_attention.launches
    got = decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    assert decode_attention.launches == before
    assert got.dtype == qt.dtype and got.shape == (b, h, hd)
    pallas = pallas_decode(qj, kj, vj, jnp.asarray(lengths), block_s=bs,
                           interpret=True)
    ref = kref.decode_attention_ref(qj, kj, vj, jnp.asarray(lengths))
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])


def test_decode_attention_empty_row_is_zero_like_pallas():
    """A row with length 0 gives 0 in the port, as in the Pallas kernel
    (the jnp oracle would average v there)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 4, 32), (3, 100, 2, 32), (3, 100, 2, 32)))
    lengths = np.array([0, 1, 100], np.int32)
    got = decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           torch.from_numpy(lengths)).numpy()
    pallas = np.asarray(pallas_decode(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(lengths),
                                      block_s=64, interpret=True))
    assert np.all(got[0] == 0)
    np.testing.assert_allclose(got, pallas, **TOL["float32"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [0, 5])
def test_ops_flash_attention_bshd_vs_jax(window, dtype):
    """The (B, S, H, hd) entry point: the same transposes to flat rows
    as ``repro.kernels.ops.flash_attention``."""
    rng = np.random.default_rng(11)
    b, s, h, hkv, hd = 2, 24, 4, 2, 16
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    want = jops.flash_attention(qj, kj, vj, causal=True, window=window)
    assert got.shape == (b, s, h, hd)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ops_decode_attention_vs_jax(dtype):
    rng = np.random.default_rng(12)
    b, s, h, hkv, hd = 3, 40, 8, 2, 16
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((b, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    lengths = np.array([1, 17, 40], np.int32)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    want = jops.decode_attention(qj, kj, vj, jnp.asarray(lengths))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("cache_len", ["int", "scalar", "vector"])
def test_model_decode_attention_takes_scalar_or_vector_len(cache_len):
    """``models.attention.decode_attention`` accepts the JAX module's
    scalar or (B,) ``cache_len`` and matches its jnp attention."""
    from repro.models import attention as jattn
    rng = np.random.default_rng(13)
    b, s, h, hkv, hd = 2, 30, 4, 1, 8
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, 1, h, hd), (b, s, hkv, hd),
                             (b, s, hkv, hd)))
    n = {"int": 19, "scalar": np.int32(19),
         "vector": np.array([19, 7], np.int32)}[cache_len]
    port_len = n if cache_len == "int" else torch.from_numpy(np.asarray(n))
    got = tattn.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 port_len)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(n))
    assert got.shape == (b, 1, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_model_attention_not_on_path_raises():
    """``q_offset != 0`` raises (not on a path); ``decode_attention_sp``
    (A12.1) is ``decode_attention`` without a mesh and, under a logical
    mesh of m sequence shards, agrees with it within ``TOL``."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import ctx as tctx
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.multi_head_attention(q, q, q, q_offset=3)
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(shape, generator=g)
               for shape in ((2, 1, 4, 8), (2, 12, 2, 8), (2, 12, 2, 8)))
    want = tattn.decode_attention(q, k, v, 9)
    assert torch.equal(tattn.decode_attention_sp(q, k, v, 9), want)
    for m in (1, 3, 4):
        with tctx.use_mesh(make_test_mesh(1, m)):
            got = tattn.decode_attention_sp(q, k, v, 9)
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   **TOL["float32"])


# ------------------------------------------------------------ the wrappers


def _flash_args(**over):
    args = dict(q=torch.zeros(4, 8, 16), k=torch.zeros(2, 8, 16),
                v=torch.zeros(2, 8, 16))
    args.update(over)
    return args


@pytest.mark.parametrize("bad,exc", [
    (dict(q=torch.zeros(4, 8, 16, dtype=torch.float16),
          k=torch.zeros(2, 8, 16, dtype=torch.float16),
          v=torch.zeros(2, 8, 16, dtype=torch.float16)), TypeError),
    (dict(k=torch.zeros(2, 8, 16, dtype=torch.bfloat16)), TypeError),
    (dict(k=torch.zeros(3, 8, 16), v=torch.zeros(3, 8, 16)), ValueError),
    (dict(v=torch.zeros(2, 9, 16)), ValueError),
    (dict(q=torch.zeros(4, 8, 12), k=torch.zeros(2, 8, 12),
          v=torch.zeros(2, 8, 12)), ValueError),            # hd % 8
    (dict(q=torch.zeros(4, 8, 264), k=torch.zeros(2, 8, 264),
          v=torch.zeros(2, 8, 264)), ValueError),           # hd > 256
    (dict(q=torch.zeros(4, 16, 8).transpose(1, 2)), ValueError),
    (dict(q=torch.zeros(4, 8)), ValueError),
])
def test_flash_wrapper_rejects(bad, exc):
    with pytest.raises(exc):
        flash_attention_flat(**_flash_args(**bad))


def _decode_args(**over):
    args = dict(q=torch.zeros(2, 4, 16), k_cache=torch.zeros(2, 10, 2, 16),
                v_cache=torch.zeros(2, 10, 2, 16),
                lengths=torch.ones(2, dtype=torch.int32))
    args.update(over)
    return args


@pytest.mark.parametrize("bad,exc", [
    (dict(lengths=torch.ones(2, dtype=torch.int64)), TypeError),
    (dict(q=torch.zeros(2, 4, 16, dtype=torch.float64),
          k_cache=torch.zeros(2, 10, 2, 16, dtype=torch.float64),
          v_cache=torch.zeros(2, 10, 2, 16, dtype=torch.float64)),
     TypeError),
    (dict(v_cache=torch.zeros(2, 10, 2, 16, dtype=torch.bfloat16)),
     TypeError),
    (dict(lengths=torch.ones(3, dtype=torch.int32)), ValueError),
    (dict(k_cache=torch.zeros(2, 10, 3, 16),
          v_cache=torch.zeros(2, 10, 3, 16)), ValueError),  # H % Hkv
    (dict(q=torch.zeros(2, 4, 20), k_cache=torch.zeros(2, 10, 2, 20),
          v_cache=torch.zeros(2, 10, 2, 20)), ValueError),  # hd % 8
    (dict(q=torch.zeros(2, 64, 256), k_cache=torch.zeros(2, 10, 1, 256),
          v_cache=torch.zeros(2, 10, 1, 256)), ValueError),  # group > 8192
])
def test_decode_wrapper_rejects(bad, exc):
    with pytest.raises(exc):
        decode_attention(**_decode_args(**bad))


def test_wrappers_launch_or_raise_off_cpu(monkeypatch):
    """A tensor off the CPU never takes the plain version: on the meta
    device (which needs no card) the wrappers take the meta route, which
    allocates the kernel's output, launches nothing, moves no launch
    counter and tallies one call of the kernel's source."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import work

    def plain(*a, **kw):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(fmod, "attention_flat_plain", plain)
    monkeypatch.setattr(dmod, "decode_attention_plain", plain)
    counts = (flash_attention_flat.launches, decode_attention.launches)
    with work.KernelTally() as tally:
        meta = {k: v.to("meta") for k, v in _flash_args().items()}
        out = flash_attention_flat(**meta)
        assert (out.device.type, out.shape) == ("meta", meta["q"].shape)
        meta = {k: v.to("meta") for k, v in _decode_args().items()}
        out = decode_attention(**meta)
        assert (out.device.type, out.shape) == ("meta", meta["q"].shape)
    assert (flash_attention_flat.launches,
            decode_attention.launches) == counts
    assert tally.launches() == {
        fmod.fwd_source(meta["q"].dtype, meta["q"].shape[-1]): 1,
        dmod.SOURCE: 1}


# ------------------------------------- (B, S, H, hd) views read in place


def _views(kind, b, s, h, hkv, hd, rng):
    """q, k, v as non-contiguous (B, S, H, hd) views: slices of one fused
    projection output, or heads-first storage transposed."""
    if kind == "fused":
        x = rng.standard_normal((b, s, h + 2 * hkv, hd)).astype(np.float32)
        return x, (lambda t: (t[:, :, :h], t[:, :, h:h + hkv],
                              t[:, :, h + hkv:]))
    x = rng.standard_normal((b, h + 2 * hkv, s, hd)).astype(np.float32)
    return x, (lambda t: tuple(
        u.transpose(1, 2) if isinstance(u, torch.Tensor)
        else u.transpose(0, 2, 1, 3)
        for u in (t[:, :h], t[:, h:h + hkv], t[:, h + hkv:])))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,window", [("fused", 0), ("fused", 7),
                                         ("heads_first", 0),
                                         ("heads_first", 7)])
def test_ops_flash_attention_strided_views_vs_jax(kind, window, dtype):
    """``ops.flash_attention`` on (B, S, H, hd) views whose strides are not
    contiguous (on the card the bf16 kernel reads them in place; here the
    plain version) against the JAX package's ``ops.flash_attention``."""
    rng = np.random.default_rng(21)
    b, s, h, hkv, hd = 2, 40, 4, 2, 24
    x, split = _views(kind, b, s, h, hkv, hd, rng)
    xj, xt = _pair(x, dtype)
    qt, kt, vt = split(xt)
    qj, kj, vj = split(xj)
    assert not qt.is_contiguous() and not kt.is_contiguous()
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    want = jops.flash_attention(qj, kj, vj, causal=True, window=window)
    assert got.shape == (b, s, h, hd) and got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("view,copied", [
    ("contiguous", False), ("fused_slice", False), ("heads_first", False),
    ("stride_not_8", True), ("inner_stride", True), ("base_offset", True)])
def test_flash_bshd_reads_aligned_views_in_place(view, copied):
    """The bf16 kernel reads a view in place when its innermost stride is
    1, its other strides are multiples of 8 elements and its base is
    16-byte aligned; any other view is copied to a contiguous tensor
    first (the rule of ``flash_attention_bshd``'s docstring)."""
    from repro_torch.kernels.flash_attention import _aligned
    base = torch.zeros(2, 10, 12, 16, dtype=torch.bfloat16)
    t = {"contiguous": base,
         "fused_slice": base[:, :, 4:8],
         "heads_first": base.permute(0, 2, 1, 3),
         "stride_not_8": torch.zeros(2, 10, 3, 20,
                                     dtype=torch.bfloat16)[..., :16],
         "inner_stride": base.transpose(2, 3)[:, :, :12, :],
         "base_offset": base.reshape(-1)[1:1 + 2 * 10 * 12 * 8].view(
             2, 10, 12, 8)}[view]
    out = _aligned(t)
    assert (out is not t) == copied
    assert torch.equal(out, t)
    if copied:
        assert out.is_contiguous() and out.data_ptr() % 16 == 0


# ------------------------------------------- flash-decoding split + combine


def _split_combine(q, k, v, lengths, chunk):
    """The split kernel's arithmetic rebuilt in plain torch: one partial
    (m, l, acc) per chunk of ``chunk`` positions and head, the empty
    partial (m = -1e30, l = 0, acc = 0) for a chunk at or past the row's
    length, then the combine kernel's merge."""
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qpk = h // hkv
    n_split = max(1, -(-s // chunk))
    m = torch.full((b, h, n_split), -1e30)
    l = torch.zeros(b, h, n_split)
    acc = torch.zeros(b, h, n_split, hd)
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), s)
        for i in range(n_split):
            first, last = i * chunk, min((i + 1) * chunk, n)
            if first >= last:
                continue
            kk = k[bi, first:last].float().repeat_interleave(qpk, dim=1)
            vv = v[bi, first:last].float().repeat_interleave(qpk, dim=1)
            sc = torch.einsum("hd,nhd->hn", q[bi].float(), kk) / math.sqrt(hd)
            m[bi, :, i] = sc.max(-1).values
            p = torch.exp(sc - m[bi, :, i, None])
            l[bi, :, i] = p.sum(-1)
            acc[bi, :, i] = torch.einsum("hn,nhd->hd", p, vv)
    big = m.max(-1, keepdim=True).values
    w = torch.exp(m - big)
    den = (w * l).sum(-1).clamp_min(1e-30)
    return (w[..., None] * acc).sum(2) / den[..., None]


@pytest.mark.parametrize("b,h,hkv,s,hd", [(6, 4, 2, 200, 16),
                                          (6, 16, 8, 1056, 16)])
def test_decode_split_combine_vs_jax(b, h, hkv, s, hd):
    """Lengths 0, 1, chunk - 1, chunk, chunk + 1 and S, with the kernel's
    own chunk for this shape: every row within 2e-5 of the JAX oracle,
    the length-0 row exactly 0 (no NaN from an all-empty combine)."""
    from repro_torch.kernels.decode_attention import n_splits, split_chunk
    chunk = split_chunk(b, hkv, s)
    assert chunk % 32 == 0 and n_splits(b, hkv, s) == -(-s // chunk)
    lengths = np.array([0, 1, chunk - 1, chunk, chunk + 1, s], np.int32)
    rng = np.random.default_rng(s + h)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    got = _split_combine(*(torch.from_numpy(x) for x in (q, k, v)),
                         lengths, chunk).numpy()
    want = np.asarray(kref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)))
    assert np.all(got[0] == 0)
    np.testing.assert_allclose(got[1:], want[1:], **TOL["float32"])
    plain = decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, plain, **TOL["float32"])


@pytest.mark.parametrize("b,hkv,s,want_chunk", [
    (4, 1, 2048, 32),        # recurrentgemma's ring buffer (MQA)
    (4, 8, 1056, 128),       # qwen3_4b's decode
    (4, 8, 8192, 512),
    (1, 1, 0, 32)])
def test_decode_split_fills_the_card(b, hkv, s, want_chunk):
    """The split grid comes from the shapes alone and gives at least one
    block per SM of an H100 (132) at both serving shapes."""
    from repro_torch.kernels.decode_attention import n_splits, split_chunk
    assert split_chunk(b, hkv, s) == want_chunk
    if s >= 1024:
        assert b * hkv * n_splits(b, hkv, s) >= 132
    assert n_splits(b, hkv, s) >= 1
