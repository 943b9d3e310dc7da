"""The r2 fastddc batch functions of csdr_tpu_torch (the inverse's readable
specification, its dense-fold and factored matrix forms, and the factored
host arrays) against csdr_tpu's on the same seeded spectra.

csdr_tpu's own bar for the factored forms (tests/test_fastddc.py) is a
relative error under 1e-5 against the fused dense matrix; the same bar
holds each port function against csdr_tpu's here, and the host arrays
are csdr_tpu's bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu.core.cplx import CF
from csdr_tpu.ops import fastddc as jfd

from csdr_tpu_torch.ops import fastddc as tfd

torch.set_num_threads(2)

RATES = [0.1, -0.23, 0.37, 0.02]
REL_BAR = 1e-5


def _spectra(ddc, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, ddc.fft_size))
            + 1j * rng.standard_normal((b, ddc.fft_size))).astype(
                np.complex64)


def _cf(a):
    return CF(jnp.asarray(a.real.copy()), jnp.asarray(a.imag.copy()))


def _np(y):
    return np.asarray(y.re) + 1j * np.asarray(y.im)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("d", [8, 16, 20, 50])
def test_inv_batch_matches_csdr_tpu(d):
    """The step-by-step inverse (gather, taps, fold, swap, iFFT, scrap)."""
    ddc = tfd.fastddc_init(0.05, d)
    sp = _spectra(ddc, 6, d)
    rows = [tfd.channel_arrays(ddc, r) for r in RATES]
    taps = np.stack([t for t, _, _ in rows])
    perm = np.stack([p for _, p, _ in rows])
    jrows = [jfd.channel_arrays(jfd.fastddc_init(0.05, d), r) for r in RATES]
    np.testing.assert_array_equal(taps, np.stack([t for t, _, _ in jrows]))
    np.testing.assert_array_equal(perm, np.stack([p for _, p, _ in jrows]))
    got = tfd.fastddc_inv_batch(torch.from_numpy(sp), ddc,
                                torch.from_numpy(taps), perm).numpy()
    ref = _np(jfd.fastddc_inv_batch(_cf(sp), jfd.fastddc_init(0.05, d),
                                    _cf(taps), jnp.asarray(perm)))
    assert got.shape == ref.shape == (6, len(RATES), ddc.post_input_size)
    assert _rel(got, ref) < REL_BAR


@pytest.mark.parametrize("d", [16, 50])
def test_inv_batch_mxu_matches_csdr_tpu_and_spec(d):
    """The dense fold-matrix product equals csdr_tpu's (HIGHEST) and the
    port's own readable specification."""
    ddc = tfd.fastddc_init(0.05, d)
    sp = _spectra(ddc, 6, 100 + d)
    fold = np.concatenate([tfd.channel_matrix(ddc, r) for r in RATES], 1)
    jddc = jfd.fastddc_init(0.05, d)
    np.testing.assert_array_equal(
        fold, np.concatenate([jfd.channel_matrix(jddc, r) for r in RATES], 1))
    got = tfd.fastddc_inv_batch_mxu(torch.from_numpy(sp), ddc,
                                    torch.from_numpy(fold)).numpy()
    ref = _np(jfd.fastddc_inv_batch_mxu(
        _cf(sp), jddc, _cf(fold), precision=jax.lax.Precision.HIGHEST))
    assert _rel(got, ref) < REL_BAR
    rows = [tfd.channel_arrays(ddc, r) for r in RATES]
    spec = tfd.fastddc_inv_batch(
        torch.from_numpy(sp), ddc,
        torch.from_numpy(np.stack([t for t, _, _ in rows])),
        np.stack([p for _, p, _ in rows])).numpy()
    assert _rel(got, spec) < REL_BAR
    with pytest.raises(ValueError, match="precision"):
        tfd.fastddc_inv_batch_mxu(torch.from_numpy(sp), ddc,
                                  torch.from_numpy(fold), precision="LOW")


@pytest.mark.parametrize("d", [4, 16, 64])
def test_factored_arrays_match_csdr_tpu(d):
    """TQ, the rolled E and the frame cycles, bit for bit; E_c is W
    scaled by the factored-v2 diagonal d_c."""
    ddc = tfd.fastddc_init(0.05, d)
    tq, e, cyc = tfd.channel_factored_arrays(ddc, RATES)
    jtq, je, jcyc = jfd.channel_factored_arrays(jfd.fastddc_init(0.05, d),
                                                RATES)
    np.testing.assert_array_equal(tq, jtq)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(cyc, jcyc)
    _, w, dg, cyc2 = tfd.channel_factored2_arrays(ddc, RATES)
    np.testing.assert_allclose(cyc, cyc2)
    for ci in range(len(RATES)):
        np.testing.assert_allclose(e[ci], w * dg[ci][None, :], rtol=2e-5,
                                   atol=2e-6)


@pytest.mark.parametrize("d", [8, 16, 32])
def test_factored_batch_matches_csdr_tpu_and_fused(d):
    """The factored product against csdr_tpu's (HIGHEST) and against the
    fused dense matrix (csdr_tpu's bar: relative error < 1e-5)."""
    ddc = tfd.fastddc_init(0.05, d)
    sp = _spectra(ddc, 16, d)
    tq, e, _ = tfd.channel_factored_arrays(ddc, RATES)
    got = tfd.fastddc_inv_factored_batch(torch.from_numpy(sp),
                                         torch.from_numpy(tq),
                                         torch.from_numpy(e)).numpy()
    ref = _np(jfd.fastddc_inv_factored_batch(
        _cf(sp), _cf(tq), _cf(e), precision=jax.lax.Precision.HIGHEST))
    assert got.shape == ref.shape
    assert _rel(got, ref) < REL_BAR
    g = np.concatenate([tfd.channel_fused_matrix(ddc, r)[0] for r in RATES],
                       1)
    m = ddc.post_input_size // ddc.post_decimation
    fused = (sp @ g).reshape(16, len(RATES), m).transpose(1, 0, 2)
    assert _rel(got, fused) < REL_BAR


def test_factored_batch_equals_factored2_and_block():
    """r2 and factored-v2 are one map: the r2 product with the frame NCO
    applied equals the K4 block's plain version over the same spectra."""
    ddc = tfd.fastddc_init(0.05, 16)
    sp = _spectra(ddc, 8, 5)
    tq, e, cyc = tfd.channel_factored_arrays(ddc, RATES)
    y = tfd.fastddc_inv_factored_batch(torch.from_numpy(sp),
                                       torch.from_numpy(tq),
                                       torch.from_numpy(e))
    ramp = np.mod(np.arange(8)[None, :] * cyc[:, None], 1.0)
    rot = np.exp(2j * np.pi * ramp.astype(np.float32))
    want = (y.numpy() * rot[:, :, None]).reshape(len(RATES), -1)
    blk = tfd.fastddc_inv_block(ddc, RATES)
    _, out = blk(blk.init("cpu"), torch.from_numpy(sp))
    assert _rel(out.data.numpy(), want) < REL_BAR
