"""The sample-format converters of csdr_tpu_torch against csdr_tpu, bit for
bit, edge values included: +-inf, NaN and values out of every type's range
(csdr_tpu's XLA casts saturate from float32 to int32, then wrap to the
narrow type), every u8, s8 and s16 value, s24 in both byte orders; and the
stream runner taking raw u8 I/Q bytes as csdr_tpu's does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu.core import cplx as jcplx
from csdr_tpu.ops import convert as jconv

from csdr_tpu_torch.core import cplx as tcplx
from csdr_tpu_torch.ops import convert as tconv

torch.set_num_threads(2)

EDGES = np.array([-np.inf, np.inf, np.nan, -np.nan, 3e9, -3e9, 2.2e9,
                  -2.2e9, 1e6, -1e6, 65536.5, -40000.7, 1.0, -1.0, 0.0,
                  -0.0, 1.0000001, -1.0000001, 0.99999994, -0.99999994,
                  0.5, -0.5, 1.5e-45, 255.9, -128.2, 2.0, -2.0],
                 np.float32)


def _floats(seed: int) -> np.ndarray:
    """EDGES, then values in and a little past [-1, 1], then large ones."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        EDGES, rng.uniform(-1.2, 1.2, 3000).astype(np.float32),
        (rng.standard_normal(500) * 1e5).astype(np.float32)])


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(b.view(np.uint8) if b.dtype.kind == "f"
                                  else b,
                                  a.view(np.uint8) if a.dtype.kind == "f"
                                  else a)


@pytest.mark.parametrize("name", ["convert_f_u8", "convert_f_s8",
                                  "convert_f_s16"])
def test_float_to_int_bit_exact(name):
    x = _floats(1)
    _same(getattr(jconv, name)(jnp.asarray(x)),
          getattr(tconv, name)(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("name,dtype", [
    ("convert_u8_f", np.uint8), ("convert_s8_f", np.int8),
    ("convert_s16_f", np.int16)])
def test_int_to_float_every_value(name, dtype):
    info = np.iinfo(dtype)
    x = np.arange(info.min, info.max + 1).astype(dtype)
    _same(getattr(jconv, name)(jnp.asarray(x)),
          getattr(tconv, name)(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("bigendian", [False, True])
def test_s24_both_ways_bit_exact(bigendian):
    x = _floats(2)
    jb = jconv.convert_f_s24(jnp.asarray(x), bigendian)
    tb = tconv.convert_f_s24(torch.from_numpy(x), bigendian)
    _same(jb, tb.numpy())
    raw = np.random.default_rng(3).integers(0, 256, 3 * 4000).astype(np.uint8)
    raw[:12] = [0, 0, 0, 255, 255, 255, 128, 0, 0, 127, 255, 255]
    _same(jconv.convert_s24_f(jnp.asarray(raw), bigendian),
          tconv.convert_s24_f(torch.from_numpy(raw), bigendian).numpy())


def test_f32_to_i32_saturates_like_xla():
    x = _floats(4)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    _same(want, tconv.f32_to_i32(torch.from_numpy(x)).numpy())
    want16 = np.asarray(jnp.asarray(x * 100).astype(jnp.int16))
    _same(want16, tconv.f32_to_i16_saturating(
        torch.from_numpy(x) * 100).numpy())


def test_complex_pairing():
    rng = np.random.default_rng(5)
    b = rng.integers(0, 256, 2 * 1000).astype(np.uint8)
    j = jcplx.to_numpy(jconv.convert_u8_c(jnp.asarray(b)))
    t = tconv.convert_u8_c(torch.from_numpy(b))
    assert t.dtype == torch.complex64
    _same(j.astype(np.complex64), t.numpy())
    s = rng.integers(-32768, 32768, 2 * 1000).astype(np.int16)
    _same(jcplx.to_numpy(jconv.convert_s16_c(jnp.asarray(s))
                         ).astype(np.complex64),
          tconv.convert_s16_c(torch.from_numpy(s)).numpy())
    f = rng.standard_normal(2 * 500).astype(np.float32)
    cf = jconv.interleaved_to_cf(jnp.asarray(f))
    tc = tconv.interleaved_to_cf(torch.from_numpy(f))
    _same(jcplx.to_numpy(cf).astype(np.complex64), tc.numpy())
    _same(jconv.cf_to_interleaved(cf), tconv.cf_to_interleaved(tc).numpy())


def test_stereo_mono():
    rng = np.random.default_rng(6)
    s = rng.integers(-32768, 32768, 2000).astype(np.int16)
    s[:8] = [32767, 32767, -32768, -32768, 32767, -32768, -1, 0]
    _same(jconv.mono2stereo_s16(jnp.asarray(s)),
          tconv.mono2stereo_s16(torch.from_numpy(s)).numpy())
    _same(jconv.stereo2mono_s16(jnp.asarray(s)),
          tconv.stereo2mono_s16(torch.from_numpy(s)).numpy())


def test_from_numpy_keeps_integer_types():
    """u8 I/Q bytes and s16 audio reach a pipeline as they are, as
    csdr_tpu's stream runner passes them; floats become float32."""
    for dtype in (np.uint8, np.int8, np.int16, np.int32):
        assert tcplx.from_numpy(np.zeros(4, dtype), "cpu").numpy().dtype \
            == dtype
    assert tcplx.from_numpy(np.zeros(4), "cpu").dtype == torch.float32
    assert tcplx.from_numpy(np.zeros(4, np.complex128), "cpu").dtype \
        == torch.complex64
