"""The SSB receiver of csdr_tpu_torch against csdr_tpu: the FFT bandpass
(overlap-add through K3's plain version on the CPU) and the whole
ssb_receiver(agc_on=False) chain, streamed chunk by chunk on the same numpy
inputs, plus csdr_tpu's own tone test run on the port."""

import jax
import numpy as np
import pytest
import torch

from csdr_tpu.core import cplx as jcplx
from csdr_tpu.models import receivers as jrec
from csdr_tpu.ops import fftfilt as jff

import csdr_tpu_torch
from csdr_tpu_torch import run_offline
from csdr_tpu_torch.models import receivers as trec
from csdr_tpu_torch.ops import demod as tdemod
from csdr_tpu_torch.ops import fftfilt as tff
from csdr_tpu_torch.ops import util_ops as tutil

from tests.util import assert_snr, cplx_noise

torch.set_num_threads(2)


def _stream(pj, pt, x, n, sj=None, st=None):
    sj = pj.init() if sj is None else sj
    st = pt.init("cpu") if st is None else st
    oj, ot = [], []
    for c in range(len(x) // n):
        chunk = x[c * n:(c + 1) * n]
        sj, yj = pj.apply(sj, jcplx.from_numpy(chunk))
        with torch.no_grad():
            st, yt = pt(st, torch.from_numpy(chunk))
        oj.append(jcplx.to_numpy(yj) if isinstance(yj, jcplx.CF)
                  else np.asarray(yj))
        ot.append(yt.numpy())
    return np.concatenate(oj), np.concatenate(ot), sj, st


@pytest.mark.parametrize("low,high,bw,interpret", [
    (0.0, 0.1, 0.05, None), (0.0, 0.1, 0.05, "1"), (-0.2, -0.05, 0.05, None),
    (-0.1, 0.2, 0.014, None)],
    ids=["usb", "usb_jax_kernel", "lsb", "overlap_exceeds_input"])
def test_bandpass_fir_fft_matches_jax(monkeypatch, low, high, bw, interpret):
    """3 chunks; >= 90 dB, csdr_tpu's bar between its kernel and fallback
    (tests/test_fftfilt.py).  bw=0.014 has overlap > input_size.  With
    ``interpret`` csdr_tpu runs its matmul-FFT kernel pair in interpret
    mode, in kernel bin order like the port."""
    if interpret:
        monkeypatch.setenv("CSDR_PALLAS_INTERPRET", interpret)
    jb = jff.bandpass_fir_fft_block(low, high, bw)
    tb = tff.bandpass_fir_fft_block(low, high, bw)
    assert (tb.fft_size, tb.input_size, tb.overlap) == \
        (jb.fft_size, jb.input_size, jb.overlap)
    assert tb.taps_fft_ko is not None
    n = 2 * tb.input_size
    x = cplx_noise(3 * n, seed=1)
    a, b, _, _ = _stream(jb, tb, x, n)
    assert_snr(a, b, 90, f"bandpass_fir_fft {low} {high} {bw}")


def test_bandpass_taps_spectra_equal():
    j = jff.bandpass_taps_spectra(0.05, 0.0, 0.1)
    t = tff.bandpass_taps_spectra(0.05, 0.0, 0.1)
    for a, b in zip(j, t):
        assert np.array_equal(jcplx.to_numpy(a), b.numpy())


def test_bandpass_state_from_jax_leaves():
    """csdr_tpu runs chunk 1; its (carry, taps_fft, taps_fft_ko) leaves go
    into the port, which runs chunk 2 like csdr_tpu; other taps raise."""
    jb = jff.bandpass_fir_fft_block(0.0, 0.1, 0.05)
    n = 3 * jb.input_size
    x = cplx_noise(2 * n, seed=2)
    sj, _ = jb.apply(jb.init(), jcplx.from_numpy(x[:n]))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(sj)]
    tb = tff.bandpass_fir_fft_block(0.0, 0.1, 0.05)
    st = csdr_tpu_torch.state_from_jax_leaves(tb, leaves, device="cpu")
    _, yj = jb.apply(sj, jcplx.from_numpy(x[n:]))
    with torch.no_grad():
        _, yt = tb(st, torch.from_numpy(x[n:]))
    assert_snr(jcplx.to_numpy(yj), yt.numpy(), 90, "resumed bandpass")
    with pytest.raises(ValueError, match="differs"):
        csdr_tpu_torch.state_from_jax_leaves(
            tff.bandpass_fir_fft_block(0.0, 0.12, 0.05), leaves, device="cpu")


def test_realpart_and_limit():
    x = torch.tensor([1.5 - 2j, -0.25 + 1j, -3.0 + 0j])
    y = tutil.limit_ff(tdemod.realpart_cf(x), 1.0)
    assert y.tolist() == [1.0, -0.25, -1.0]


def test_ssb_receiver_matches_jax():
    """ssb_receiver(agc_on=False) against csdr_tpu's with its XLA FIR
    (use_pallas=False), 3 chunks of 2*50*178 samples; the audio stays
    well inside limit_ff's clamp, so this holds the filters, not the
    clamp."""
    pj = jrec.ssb_receiver(0.0, 0.1, 0.05, decimation=50, agc_on=False,
                           use_pallas=False)
    pt = trec.ssb_receiver(0.0, 0.1, 0.05, decimation=50, agc_on=False)
    assert [b.name for b in pt.blocks] == [b.name for b in pj.blocks]
    n = 2 * 50 * pt.blocks[1].input_size
    x = 0.3 * cplx_noise(3 * n, seed=3)
    a, b, _, _ = _stream(pj, pt, x, n)
    assert b.dtype == np.float32 and np.abs(b).max() < 1.0
    assert_snr(a, b, 90, "ssb_receiver(agc_on=False)")


def test_ssb_receiver_recovers_tone():
    """csdr_tpu's tone test (tests/test_receivers.py) on the port: a
    0.0005-rate input tone comes out at 0.025 after decimation by 50; a
    tone at -0.004 lands at -0.2, outside the USB passband."""
    d = 50
    pipe = trec.ssb_receiver(0.0, 0.1, 0.05, decimation=d, agc_on=False)
    ins = d * pipe.blocks[1].input_size
    n = ins * max(1, (1 << 20) // ins)
    tone = np.exp(1j * 2 * np.pi * 0.0005 * np.arange(n)).astype(np.complex64)
    y = run_offline(pipe, tone, block_size=13 * ins, device="cpu")
    seg = y[2000:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    peak = np.argmax(spec) / len(seg)
    assert abs(peak - 0.0005 * d) < 0.002, peak
    tone2 = np.exp(-1j * 2 * np.pi * 0.004 * np.arange(n)).astype(np.complex64)
    y2 = run_offline(pipe, tone2, block_size=13 * ins, device="cpu")
    assert np.abs(y2[2000:]).mean() < 0.02 * np.abs(y[2000:]).mean()


def test_ssb_receiver_agc_not_ported_and_cuda_rule(monkeypatch):
    """agc_on=True (the default) builds the AGC block, which once raised
    here; tests/test_torch_receivers.py holds it against csdr_tpu.  Then
    the device rule: without CUDA the entry points raise unless the caller
    asks for the CPU."""
    names = [b.name for b in trec.ssb_receiver().blocks]
    assert names == ["fir_decimate_cc", "bandpass_fir_fft_cc", "realpart_cf",
                     "agc_ff", "limit_ff"]
    assert trec.ssb_receiver().blocks[3].method == "chunked"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pipe = trec.ssb_receiver(agc_on=False)
    x = np.zeros(2 * 8900, np.complex64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_offline(pipe, x, block_size=8900)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipe.init()
    assert run_offline(pipe, x, block_size=8900, device="cpu").shape == (356,)
