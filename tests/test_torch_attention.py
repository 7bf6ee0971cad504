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
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.multi_head_attention(q, q, q, q_offset=3)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tattn.decode_attention_sp(q, q, q, 1)


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


def test_wrappers_launch_or_raise_off_cpu():
    """A tensor off the CPU never takes the plain version: a device with
    no kernel raises instead (here the meta device, which needs no
    card)."""
    counts = (flash_attention_flat.launches, decode_attention.launches)
    meta = {k: v.to("meta") for k, v in _flash_args().items()}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention_flat(**meta)
    meta = {k: v.to("meta") for k, v in _decode_args().items()}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        decode_attention(**meta)
    assert (flash_attention_flat.launches,
            decode_attention.launches) == counts
