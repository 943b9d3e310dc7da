"""The traced-rate NCO of csdr_tpu_torch (ops/shift: _frac_mul, _wrap_phase,
shift_cc with a tensor rate, decimating_shift_cc) against csdr_tpu.

csdr_tpu runs these inside ``jax.jit`` (the DDC server's step, its dynamic
blocks), where XLA's CPU backend contracts ``a*b + c`` into one fused
multiply-add; eager JAX rounds the product first.  The port reproduces the
compiled form (core/precision.fma_f32), so the comparisons here are
against jitted csdr_tpu.  Phases, fractions, counts and offsets are held
bit for bit; mixed samples, which go through each package's own cos/sin,
at >= 110 dB (the bar of tests/test_torch_fir.py's static shift).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu.core.cplx import CF
from csdr_tpu.ops import shift as jshift

from csdr_tpu_torch.ops import shift as tshift

from tests.util import assert_snr, cplx_noise

torch.set_num_threads(2)

RATES = np.random.default_rng(7).uniform(-0.5, 0.5, 12).astype(np.float32)
EDGE_RATES = np.asarray([1e-6, -3.7e-7, 0.4999999, -0.5, 0.0, 2.0 ** -13],
                        np.float32)


def _cf(x: np.ndarray) -> CF:
    return CF(jnp.asarray(x.real.astype(np.float32)),
              jnp.asarray(x.imag.astype(np.float32)))


def _np(a: CF) -> np.ndarray:
    return np.asarray(a.re) + 1j * np.asarray(a.im)


@functools.lru_cache(maxsize=None)
def _jit_frac_mul(max_val: int):
    return jax.jit(lambda i, r: jshift._frac_mul(i, r, max_val))


@pytest.mark.parametrize("rate", list(RATES) + list(EDGE_RATES))
def test_frac_mul_bit_for_bit(rate):
    """idx over [0, 2^24] in strides that reach every digit."""
    idx = np.concatenate([np.arange(0, 1 << 24, 4093, dtype=np.int32),
                          np.asarray([4095, 4096, (1 << 24) - 1, 1 << 24],
                                     np.int32)])
    want = np.asarray(_jit_frac_mul(1 << 24)(jnp.asarray(idx),
                                             jnp.float32(rate)))
    got = tshift._frac_mul(torch.from_numpy(idx), torch.tensor(rate),
                           1 << 24).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_frac_mul_scalar_index_over_channel_rates():
    """One index (a chunk length) against a row of per-channel rates, and
    the two loop lengths max_val picks (one digit, two digits)."""
    rates = np.random.default_rng(3).uniform(-0.5, 0.5, 500).astype(np.float32)
    for n in (3000, 262_144):
        want = np.asarray(_jit_frac_mul(n + 1)(jnp.int32(n),
                                               jnp.asarray(rates)))
        got = tshift._frac_mul(n, torch.from_numpy(rates), n + 1).numpy()
        np.testing.assert_array_equal(got, want)


def test_wrap_phase_bit_for_bit():
    p = np.random.default_rng(1).uniform(-40, 40, 100_000).astype(np.float32)
    p[:4] = [np.pi, -np.pi, 3 * np.pi, 0.0]
    want = np.asarray(jax.jit(jshift._wrap_phase)(jnp.asarray(p)))
    np.testing.assert_array_equal(
        tshift._wrap_phase(torch.from_numpy(p)).numpy(), want)


@pytest.mark.parametrize("rate", [np.float32(0.1237), np.float32(-0.31),
                                  np.float32(2e-5)])
def test_tensor_rate_shift_cc_matches_jax(rate):
    x = cplx_noise(5000, seed=4)
    f = jax.jit(lambda xx, r, p: jshift.shift_cc(xx, r, p))
    yj, pj = f(_cf(x), jnp.float32(rate), jnp.float32(0.7))
    y, p = tshift.shift_cc(torch.from_numpy(x), torch.tensor(rate),
                           torch.tensor(0.7))
    assert p.dtype == torch.float32
    assert float(p) == float(pj)                 # carried phase, bit for bit
    assert_snr(_np(yj), y.numpy(), 110, f"tensor rate {rate}")
    # the static (float64 host ramp) form of the same rate
    ys, _ = tshift.shift_cc(torch.from_numpy(x), float(rate), 0.7)
    assert_snr(ys.numpy(), y.numpy(), 110, "tensor vs static rate")


def test_tensor_rate_shift_cc_rows():
    """(C, n) with per-row rates and phases: each row as its own call."""
    x = np.stack([cplx_noise(3000, seed=s) for s in range(3)])
    rates = np.asarray([0.11, -0.27, 0.0031], np.float32)
    phases = np.asarray([0.0, -2.5, 3.1], np.float32)
    y, p = tshift.shift_cc(torch.from_numpy(x),
                           torch.from_numpy(rates)[:, None],
                           torch.from_numpy(phases)[:, None])
    for c in range(3):
        yc, pc = tshift.shift_cc(torch.from_numpy(x[c]),
                                 torch.tensor(rates[c]),
                                 torch.tensor(phases[c]))
        np.testing.assert_array_equal(y[c].numpy(), yc.numpy())
        assert float(p[c, 0]) == float(pc)


@pytest.mark.parametrize("sizes", [(4096, 4096, 4096), (1000, 5000, 6288),
                                   (12288,)], ids=["even", "ragged", "one"])
def test_tensor_rate_shift_cc_chunk_invariance(sizes):
    """The same stream in chunks of three sizes, the phase carried: equal
    to one call at 100 dB (csdr_tpu's phase-carry bar), and each chunk's
    carried phase csdr_tpu's bit for bit."""
    x = cplx_noise(12288, seed=8)
    rate = torch.tensor(np.float32(0.3137))
    one, _ = tshift.shift_cc(torch.from_numpy(x), rate)
    f = jax.jit(lambda xx, r, p: jshift.shift_cc(xx, r, p))
    ph, phj, outs, pos = torch.tensor(0.0), jnp.float32(0.0), [], 0
    for n in sizes:
        xc = x[pos:pos + n]
        pos += n
        y, ph = tshift.shift_cc(torch.from_numpy(xc), rate, ph)
        _, phj = f(_cf(xc), jnp.float32(0.3137), phj)
        assert float(ph) == float(phj)
        outs.append(y.numpy())
    assert_snr(one.numpy(), np.concatenate(outs), 100, f"chunks {sizes}")


@pytest.mark.parametrize("rate,traced", [(0.1, False), (-0.2375, False),
                                         (np.float32(0.1), True),
                                         (np.float32(-0.43), True)])
def test_decimating_shift_stream_matches_jax(rate, traced):
    """A stream of ragged chunks with (phase, offset) carried: count,
    next_phase and next_offset bit for bit, y at 110 dB, every chunk."""
    d = 7
    x = cplx_noise(6000, seed=11)
    if traced:
        jf = jax.jit(lambda xx, r, p, o: jshift.decimating_shift_cc(
            xx, r, d, p, o))
    else:
        jf = jax.jit(lambda xx, p, o: jshift.decimating_shift_cc(
            xx, rate, d, p, o))
    ph, off = 0.0, 0
    phj, offj = jnp.float32(0.0), jnp.int32(0)
    pos = 0
    taken = []
    for n in (1000, 1337, 13, 2650, 1000):
        xc = x[pos:pos + n]
        pos += n
        args = (_cf(xc), jnp.float32(rate)) if traced else (_cf(xc),)
        yj, cj, phj, offj = jf(*args, phj, offj)
        r = torch.tensor(rate) if traced else rate
        y, cnt, ph, off = tshift.decimating_shift_cc(torch.from_numpy(xc), r,
                                                     d, ph, off)
        assert cnt.dtype == torch.int32 and int(cnt) == int(cj)
        assert float(ph) == float(phj) and ph.dtype == torch.float32
        assert int(off) == int(offj)
        assert y.shape[0] == -(-n // d)
        k = int(cnt)
        assert_snr(_np(yj)[:k], y.numpy()[:k], 110, f"chunk of {n}")
        assert not np.any(y.numpy()[k:])
        taken.append(y.numpy()[:k])
    # the taken samples are x[::d] across the chunk boundaries
    got = np.concatenate(taken)
    manual = x[::d][: len(got)]
    osc = np.exp(2j * np.pi * np.mod(np.arange(len(got)) * float(rate), 1.0))
    assert len(got) == len(x[::d])
    assert_snr(manual * osc, got, 90, "against the composition")
