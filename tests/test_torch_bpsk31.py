"""The BPSK31 TX/RX chains of csdr_tpu_torch: csdr_tpu's BER bars
(tests/test_bpsk31.py, the reference's acceptance harness
grc_tests/bpsk31_ber.py) with the port's own noise, and the chains
against csdr_tpu's on the same baseband.  The noise streams differ (a
torch.Generator, not threefry), so BER is held to the bars, not to
csdr_tpu's counts."""

import numpy as np
import pytest
import torch

from csdr_tpu.core import cplx as jcplx
from csdr_tpu.models import bpsk31 as jbpsk

from csdr_tpu_torch.models import bpsk31 as tbpsk
from csdr_tpu_torch.ops import noise as tnoise

torch.set_num_threads(2)

TEXT = b"HELLO BPSK31 WORLD 123 " * 10


def test_tx_chain_matches_csdr_tpu():
    tb, tbb = tbpsk.tx_chain(TEXT, device="cpu")
    jb, jbb = jbpsk.tx_chain(TEXT)
    np.testing.assert_array_equal(tb, np.asarray(jb))
    # psk31_interpolate_sine_cc: XLA fuses one product into an FMA
    np.testing.assert_allclose(tbb.numpy(), jcplx.to_numpy(jbb), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("chunk", [None, 102_400])
def test_rx_chain_matches_csdr_tpu(chunk):
    """The same baseband through both receivers: the same bits (the TED is
    bit for bit; DBPSK flips only at |dphase| = pi/2)."""
    _, jbb = jbpsk.tx_chain(TEXT)
    bb = jcplx.to_numpy(jbb)
    bb = bb[: len(bb) // 102_400 * 102_400]
    t = tbpsk.rx_chain(bb, chunk=chunk, device="cpu")
    j = jbpsk.rx_chain(jcplx.from_numpy(bb), chunk=chunk)
    np.testing.assert_array_equal(t, j)


def test_bpsk31_noiseless_roundtrip():
    bits_in, bb = tbpsk.tx_chain(TEXT, device="cpu")
    errs, _ = tbpsk.align_errors(bits_in, tbpsk.rx_chain(bb, device="cpu"))
    assert errs <= 2, errs            # at most edge-symbol slips


def test_bpsk31_ber_high_snr_clean():
    ber, total = tbpsk.ber_at_snr(18.0, nchars=150, device="cpu")
    assert total > 1000               # ~8.4 varicode bits/char
    assert ber < 0.005, ber


def test_bpsk31_ber_high_snr_floor_30k():
    """At 18 dB over >= 30k bits: BER < 1e-4, and every error in the first
    32 bits (the TED's acquisition); the steady state is error-free."""
    message = tbpsk.MESSAGE
    text = (message * (3700 // len(message) + 1))[:3700]
    bits_in, bb = tbpsk.tx_chain(text, device="cpu")
    bits_out = tbpsk.rx_chain(tnoise.awgn_cc(bb, 18.0, seed=0), device="cpu")
    best = None
    for shift in range(-5, 5):
        a, b = bits_in, bits_out
        if shift < 0:
            a = np.concatenate([np.zeros(-shift, np.uint8), a])
        elif shift > 0:
            b = np.concatenate([np.zeros(shift, np.uint8), b])
        m = min(len(a), len(b))
        errpos = np.nonzero(a[:m] != b[:m])[0]
        if best is None or len(errpos) < len(best[0]):
            best = (errpos, m)
    errpos, total = best
    assert total >= 30_000, total
    assert len(errpos) / total < 1e-4, (len(errpos), total)
    assert not np.any(errpos >= 32), errpos[:20]


def test_bpsk31_ber_degrades_gracefully():
    ber_hi, _ = tbpsk.ber_at_snr(14.0, nchars=100, device="cpu")
    ber_lo, _ = tbpsk.ber_at_snr(0.0, nchars=100, device="cpu")
    assert ber_lo > ber_hi
    assert ber_hi < 0.05


def test_ber_curve_rows():
    rows = tbpsk.ber_curve([2, 16], nchars=60, device="cpu")
    assert [r[0] for r in rows] == [2, 16]
    for snr, errs, total, ber in rows:
        assert total > 400 and errs == round(ber * total)
    assert rows[0][3] > rows[1][3]
