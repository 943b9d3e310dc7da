"""The ops the CLI needs beyond the receivers' (``core/block.chain``, the
rest of ``ops/util_ops``, ``ops/mod``, ``ops/demod.fmdemod_atan_*``,
``ops/resamp.old_fractional_decimator_ff``, the rest of ``ops/fir`` and
``ops/digital.bfsk_demod_cf``) against csdr_tpu on the same seeded input.

Bit for bit where csdr_tpu's op is exact elementwise arithmetic; otherwise
at the bar csdr_tpu's own test sets for the op, named in each test (the
summation order of a product differs between XLA and torch).  Streamed
blocks run at two chunk plans, one ragged, against csdr_tpu's block on the
same chunks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu import firdes as jfirdes
from csdr_tpu.core import block as jblock
from csdr_tpu.core import cplx as jcplx
from csdr_tpu.ops import demod as jdemod
from csdr_tpu.ops import digital as jdigital
from csdr_tpu.ops import fir as jfir
from csdr_tpu.ops import mod as jmod
from csdr_tpu.ops import resamp as jresamp
from csdr_tpu.ops import util_ops as jutil

from csdr_tpu_torch import firdes
from csdr_tpu_torch.core import block as tblock
from csdr_tpu_torch.ops import demod, digital, fir, mod, resamp, util_ops

torch.set_num_threads(2)

RNG = np.random.default_rng(1301)
X = ((RNG.standard_normal(4096) + 1j * RNG.standard_normal(4096)) * 0.5
     ).astype(np.complex64)
F = (RNG.standard_normal(4096) * 0.6).astype(np.float32)
# equal chunks, and a ragged plan (every size a multiple of 4 for the
# resampler's D)
PLANS = {"even": [1024] * 4, "ragged": [1500, 4, 1092, 1000, 500]}


def _cf(x):
    return jcplx.from_numpy(np.asarray(x, np.complex64))


def _host(y):
    if isinstance(y, jcplx.CF):
        return jcplx.to_numpy(y)
    return np.asarray(y)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def snr_db(ref, test):
    ref, test = np.asarray(ref), np.asarray(test)
    assert ref.shape == test.shape, (ref.shape, test.shape)
    err = np.sum(np.abs(ref.astype(np.complex128) - test) ** 2)
    return np.inf if err == 0 else 10 * np.log10(
        np.sum(np.abs(ref.astype(np.complex128)) ** 2) / err)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype in (np.float32, np.complex64) else a


def _same(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.dtype == got.dtype and ref.shape == got.shape, (
        ref.dtype, got.dtype, ref.shape, got.shape)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def _stream_jax(blk, xs, jit=True):
    import jax
    apply = jax.jit(blk.apply) if jit else blk.apply
    state, outs = blk.init(), []
    for x in xs:
        state, y = apply(state, x)
        outs.append(_host(y))
    return np.concatenate(outs)


def _stream_torch(blk, xs):
    state, outs = blk.init("cpu"), []
    for x in xs:
        state, y = blk(state, x)
        outs.append(y.numpy())
    return np.concatenate(outs)


def _chunks(a, plan):
    out, o = [], 0
    for n in plan:
        out.append(a[o:o + n])
        o += n
    return out


def test_chain_is_a_pipeline():
    a = util_ops.dcblock_block()
    b = util_ops.fastdcblock_block()
    p = tblock.chain(a, b, name="two")
    assert isinstance(p, tblock.Pipeline) and p.name == "two"
    assert list(p.blocks) == [a, b]
    jp = jblock.chain(jutil.dcblock_block(), jutil.fastdcblock_block())
    x = F[:1000]
    _, yj = jp.apply(jp.init(), jnp.asarray(x))
    _, yt = p(p.init("cpu"), _t(x))
    # dcblock is an affine scan: its summation order differs
    assert snr_db(_host(yj), yt.numpy()) > 100


def test_monitors_and_elementwise_bit_exact():
    f = F.copy()
    f[[3, 100]] = [1.5, -2.0]
    fn = f.copy()
    fn[[7, 9, 11]] = np.nan
    assert int(util_ops.clipdetect_ff(_t(f))) == int(jutil.clipdetect_ff(
        jnp.asarray(f))) == int(np.sum(np.abs(f) > 1))
    assert int(util_ops.detect_nan_ff(_t(fn))) == int(jutil.detect_nan_ff(
        jnp.asarray(fn))) == 3
    x = X.copy()
    x[[0, 5]] = 0
    _same(_host(jutil.add_dcoffset_cc(_cf(x))),
          util_ops.add_dcoffset_cc(_t(x)).numpy())
    _same(_host(jutil.fixed_amplitude_cc(_cf(x), 0.7)),
          util_ops.fixed_amplitude_cc(_t(x), 0.7).numpy())
    _same(_host(jutil.add_ff(jnp.asarray(F), jnp.asarray(F[::-1]))),
          util_ops.add_ff(_t(F), _t(F[::-1].copy())).numpy())
    _same(_host(jmod.dsb_fc(jnp.asarray(F), 0.25)),
          mod.dsb_fc(_t(F), 0.25).numpy())
    _same(jmod.convert_f_samplerf(F[:64], 100),
          mod.convert_f_samplerf(_t(F[:64]), 100))


@pytest.mark.parametrize("nth", [1, 3])
def test_power_and_squelch(nth):
    """Powers at rtol 1e-5 (a float32 sum; csdr_tpu's own test checks the
    gate only); the gated chunk bit for bit."""
    for d in (1, nth):
        np.testing.assert_allclose(
            float(util_ops.get_power_f(_t(F), d)),
            float(jutil.get_power_f(jnp.asarray(F), d)), rtol=1e-5)
        np.testing.assert_allclose(
            float(util_ops.get_power_c(_t(X), d)),
            float(jutil.get_power_c(_cf(X), d)), rtol=1e-5)
    for level, scale in ((0.01, 1.0), (0.01, 1e-4), (0.0, 1e-4)):
        xs = (X * scale).astype(np.complex64)
        yj, pj = jutil.squelch_and_smeter_cc(_cf(xs), level, nth)
        yt, pt = util_ops.squelch_and_smeter_cc(_t(xs), level, nth)
        _same(_host(yj), yt.numpy())
        np.testing.assert_allclose(float(pt), float(pj), rtol=1e-5)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_squelch_block_streamed_with_retune(plan):
    """The level lives in the state: a retune between chunks replaces it,
    in both packages; every chunk bit for bit."""
    xs = _chunks((X * np.repeat([1.0, 1e-3, 1.0, 1e-3], 1024)
                  ).astype(np.complex64), PLANS[plan])
    jb, tb = jutil.squelch_block(), util_ops.squelch_block()
    js, ts = jb.init(), tb.init("cpu")
    for i, x in enumerate(xs):
        if i == 2:
            js, ts = jnp.float32(0.05), torch.tensor(0.05)
        js, yj = jb.apply(js, _cf(x))
        ts, yt = tb(ts, _t(x))
        _same(_host(yj), yt.numpy())


def test_fmmod_fc_against_jax():
    """csdr_tpu's own bar against the reference is atol 2e-5, the carried
    phase 1e-4 (test_coverage_extra.py).  The phase is a float32 cumsum in
    both, summed in other orders, so each package is held to the float64
    phase at that bar, and the two to each other at twice it."""
    yj, pj = jmod.fmmod_fc(jnp.asarray(F))
    yt, pt = mod.fmmod_fc(_t(F))
    phase = np.cumsum((F * np.float32(np.pi)).astype(np.float64))
    ideal = np.exp(1j * phase)
    np.testing.assert_allclose(yt.numpy(), ideal, atol=2e-5)
    np.testing.assert_allclose(_host(yj), ideal, atol=2e-5)
    np.testing.assert_allclose(yt.numpy(), _host(yj), atol=4e-5)
    wrapped = np.mod(phase[-1] + np.pi, 2 * np.pi) - np.pi
    assert abs(float(pt) - wrapped) < 1e-4
    assert abs(float(pt) - float(pj)) < 1e-4


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_fmmod_block_streamed(plan):
    """Streamed, against csdr_tpu's block on the same chunks: csdr_tpu's
    streaming bar, atol 2e-4."""
    xs = _chunks(F, PLANS[plan])
    yj = _stream_jax(jmod.fmmod_block(), [jnp.asarray(x) for x in xs], False)
    yt = _stream_torch(mod.fmmod_block(), [_t(x) for x in xs])
    np.testing.assert_allclose(yt, yj, atol=2e-4)


def test_fmdemod_atan_cf_against_jax():
    """csdr_tpu's bar against the reference, 80 dB (test_demod.py); the
    carried phase to an ulp."""
    x = np.exp(2j * np.pi * np.cumsum(0.4 * F)).astype(np.complex64) * 0.7
    yj, lj = jdemod.fmdemod_atan_cf(_cf(x), 0.3)
    yt, lt = demod.fmdemod_atan_cf(_t(x), 0.3)
    assert snr_db(_host(yj), yt.numpy()) > 80
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(float(lt), float(lj), atol=1e-6)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_fmdemod_atan_block_streamed(plan):
    x = np.exp(2j * np.pi * np.cumsum(0.4 * F)).astype(np.complex64)
    xs = _chunks(x, PLANS[plan])
    yj = _stream_jax(jdemod.fmdemod_atan_block(), [_cf(v) for v in xs])
    yt = _stream_torch(demod.fmdemod_atan_block(), [_t(v) for v in xs])
    assert snr_db(yj, yt) > 80


@pytest.mark.parametrize("taps", [None, "lowpass"])
def test_old_fractional_decimator_bit_exact(taps):
    """Host numpy in both packages, carried over two calls as the CLI
    carries it: bit for bit."""
    t = None if taps is None else firdes.firdes_lowpass_f(
        firdes.firdes_filter_len(0.1), 0.5 / 2.2)
    outs = []
    for op in (jresamp.old_fractional_decimator_ff,
               resamp.old_fractional_decimator_ff):
        pend, remain, got = np.zeros(0, np.float32), 0.0, []
        for part in (F[:2500], F[2500:]):
            x = np.concatenate([pend, part])
            y, used, remain = op(x, 2.2, t, remain)
            pend = x[used:]
            got.append(np.asarray(y, np.float32))
        outs.append(np.concatenate(got))
    _same(outs[0], outs[1])


@pytest.mark.parametrize("t,i", [(41, 2), (79, 4), (121, 5), (7, 9)])
def test_host_tap_matrices_and_frames_bit_exact(t, i):
    """The interpolator's tap-phase matrix, the resampler's masked phase
    matrix and the frames view: csdr_tpu's, bit for bit."""
    taps = firdes.firdes_lowpass_f(t, 0.5 / i)
    _same(jfir._interp_tap_matrix(taps, i), fir._interp_tap_matrix(taps, i))
    _same(jfir._resampler_phase_matrix(taps, i),
          fir._resampler_phase_matrix(taps, i))
    k = len(F) - t + 1
    _same(np.asarray(jfir._frames(jnp.asarray(F), k, t)),
          fir._frames(_t(F), k, t).numpy())


@pytest.mark.parametrize("i", [2, 5])
def test_fir_interpolate_cc_against_jax(i):
    """csdr_tpu's bar against the reference: 95 dB (test_fir.py)."""
    taps = firdes.firdes_lowpass_f(41, 0.5 / i)
    yj = _host(jfir.fir_interpolate_cc(_cf(X[:2048]), taps, i))
    yt = fir.fir_interpolate_cc(_t(X[:2048]), taps, i).numpy()
    assert snr_db(yj, yt) > 95


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_fir_interpolate_block_streamed(plan):
    taps = firdes.firdes_lowpass_f(firdes.firdes_filter_len(0.05), 0.5 / 4)
    jb, tb = jfir.fir_interpolate_block(taps, 4), fir.fir_interpolate_block(
        taps, 4)
    assert tb.warmup_out == jb.warmup_out and tb.rate_ratio == jb.rate_ratio
    xs = _chunks(X, PLANS[plan])
    yj = _stream_jax(jb, [_cf(v) for v in xs])
    yt = _stream_torch(tb, [_t(v) for v in xs])
    assert snr_db(yj, yt) > 95


def test_plain_interpolate_cc_bit_exact():
    _same(_host(jfir.plain_interpolate_cc(_cf(X[:100]), 4)),
          fir.plain_interpolate_cc(_t(X[:100]), 4).numpy())


@pytest.mark.parametrize("n,t", [(512, 31), (1500, 63), (20, 31)])
def test_apply_fir_cc_against_jax(n, t):
    """csdr_tpu's bar: 95 dB (test_fir.py), for the frames and Toeplitz
    regimes of csdr_tpu alike; an input shorter than the taps gives
    nothing (csdr_tpu's raises there)."""
    taps = firdes.firdes_bandpass_c(t, -0.1, 0.2)
    yt = fir.apply_fir_cc(_t(X[:n]), taps).numpy()
    if n < t:
        assert yt.shape == (0,)
        return
    yj = _host(jfir.apply_fir_cc(_cf(X[:n]), _cf(taps)))
    assert snr_db(yj, yt) > 95


@pytest.mark.parametrize("n,t", [(1200, 53), (300, 9)])
def test_apply_real_fir_cc_against_jax(n, t):
    taps = (RNG.standard_normal(t)).astype(np.float32)
    yj = _host(jfir.apply_real_fir_cc(_cf(X[:n]), jnp.asarray(taps)))
    yt = fir.apply_real_fir_cc(_t(X[:n]), taps).numpy()
    assert snr_db(yj, yt) > 95


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_apply_fir_cc_block_streamed(plan):
    taps = firdes.firdes_add_peak_c(33, [0.1, -0.2])
    jb, tb = jfir.apply_fir_cc_block(taps), fir.apply_fir_cc_block(taps)
    assert tb.warmup_out == jb.warmup_out
    xs = _chunks(X, PLANS[plan])
    yj = _stream_jax(jb, [_cf(v) for v in xs])
    yt = _stream_torch(tb, [_t(v) for v in xs])
    assert snr_db(yj, yt) > 95


def test_peaks_and_pulse_shaping_blocks():
    for jb, tb in ((jfir.peaks_fir_cc_block([0.1], 33),
                    fir.peaks_fir_cc_block([0.1], 33)),
                   (jfir.pulse_shaping_filter_cc_block("RRC", 8, 33, 0.25),
                    fir.pulse_shaping_filter_cc_block("RRC", 8, 33, 0.25)),
                   (jfir.pulse_shaping_filter_cc_block("COSINE", 8),
                    fir.pulse_shaping_filter_cc_block("COSINE", 8))):
        xs = _chunks(X, PLANS["ragged"])
        yj = _stream_jax(jb, [_cf(v) for v in xs])
        yt = _stream_torch(tb, [_t(v) for v in xs])
        assert snr_db(yj, yt) > 95, tb.name


@pytest.mark.parametrize("i,d", [(3, 2), (5, 4), (2, 3)])
def test_rational_resampler_ff_against_jax(i, d):
    """csdr_tpu's bar: 95 dB (test_fir.py); counts, input processed and
    the next delay exact."""
    taps = firdes.rational_resampler_get_lowpass_f(121, i, d)
    for ltd in (0, i - 1):
        y, c, ip, nd = jfir.rational_resampler_ff(jnp.asarray(F), jnp.asarray(
            taps), i, d, ltd)
        yt, ct, ipt, ndt = fir.rational_resampler_ff(_t(F), taps, i, d, ltd)
        assert (ct, ipt, ndt) == (int(c), int(ip), int(nd))
        assert snr_db(np.asarray(y), yt.numpy()) > 95
        assert not yt[ct:].any()


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_rational_resampler_block_streamed(plan):
    taps = firdes.rational_resampler_get_lowpass_f(
        firdes.firdes_filter_len(0.05), 5, 4)
    jb = jfir.rational_resampler_block(taps, 5, 4)
    tb = fir.rational_resampler_block(taps, 5, 4)
    assert tb.warmup_out == jb.warmup_out and tb.rate_ratio == jb.rate_ratio
    xs = _chunks(F, PLANS[plan])
    yj = _stream_jax(jb, [jnp.asarray(v) for v in xs], jit=False)
    yt = _stream_torch(tb, [_t(v) for v in xs])
    assert len(yt) == len(F) * 5 // 4
    assert snr_db(yj, yt) > 95


def test_bfsk_demod_cf_against_jax():
    """On apply_fir_cc, so its 95 dB bar; mark tones positive, space
    tones negative as csdr_tpu's test_bfsk_demod_sign holds."""
    mark = jfirdes.firdes_add_peak_c(65, [0.1])
    space = jfirdes.firdes_add_peak_c(65, [-0.1])
    k = np.arange(2048)
    tone = np.concatenate([np.exp(2j * np.pi * 0.1 * k),
                           np.exp(-2j * np.pi * 0.1 * k)]).astype(np.complex64)
    x = (tone + 0.1 * X[:4096]).astype(np.complex64)
    yj = np.asarray(jdigital.bfsk_demod_cf(_cf(x), _cf(mark), _cf(space)))
    yt = digital.bfsk_demod_cf(_t(x), mark, space).numpy()
    assert snr_db(yj, yt) > 95
    assert yt[100:1900].mean() > 0 > yt[2200:4000].mean()
