"""The NFM, AM and full SSB (with its AGC) receivers of csdr_tpu_torch
against csdr_tpu's, streamed chunk by chunk on the same numpy inputs at two
chunk sizes, csdr_tpu's Pallas kernels in interpret mode
(CSDR_PALLAS_INTERPRET=1) as in tests/test_torch_ssb.py; then a csdr_tpu
stream's state resumed in the port.

The reference AGC amplifies the rounding noise of the front FIR's warm-up
outputs: the first few SSB audio samples are ~1e-6, where the port's FIR
and csdr_tpu's round differently by up to 100 %, and ref/|x| ~ 1e5 there
sets the AGC's attack and decay branches.  csdr_tpu's own AGC, given the
port's pre-AGC audio instead of its own (106 dB apart), gives an output
only ~-4 dB from its own over the start-up, and the same within 1e-5 once
the gains meet, within 4000 samples.  So the SSB chain is held from
SSB_SETTLE on, and its AGC stage on csdr_tpu's own AGC input from sample
0."""

import jax
import numpy as np
import pytest
import torch

from csdr_tpu.core import cplx as jcplx
from csdr_tpu.models import receivers as jrec

import csdr_tpu_torch
from csdr_tpu_torch.models import receivers as trec

from tests.util import assert_snr

torch.set_num_threads(2)

FS = 2_400_000
BAR = 80.0
SSB_SETTLE = 4000          # audio samples of the SSB AGC's start-up


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("CSDR_PALLAS_INTERPRET", "1")


def _out(y):
    return jcplx.to_numpy(y) if isinstance(y, jcplx.CF) else np.asarray(y)


def _stream(pj, pt, x, n, sj=None, st=None):
    sj = pj.init() if sj is None else sj
    st = pt.init("cpu") if st is None else st
    oj, ot = [], []
    for c in range(len(x) // n):
        chunk = x[c * n:(c + 1) * n]
        sj, yj = pj.apply(sj, jcplx.from_numpy(chunk))
        with torch.no_grad():
            st, yt = pt(st, torch.from_numpy(chunk))
        oj.append(_out(yj))
        ot.append(yt.numpy())
    return np.concatenate(oj), np.concatenate(ot), sj, st


def _nfm_input(n, seed=0):
    """A 1 kHz tone at 2.5 kHz deviation plus a little complex noise."""
    t = np.arange(n) / FS
    phase = 2 * np.pi * np.cumsum(0.5 * np.sin(2 * np.pi * 1000 * t)) \
        * 5000 / FS
    rng = np.random.default_rng(seed)
    return (np.exp(1j * phase) + 0.01 * (rng.standard_normal(n) + 1j
            * rng.standard_normal(n))).astype(np.complex64)


def _am_input(n, seed=1):
    """A 1 kHz tone at depth 0.5 on a carrier at 0 Hz, plus noise."""
    t = np.arange(n) / FS
    rng = np.random.default_rng(seed)
    return (0.3 * (1 + 0.5 * np.sin(2 * np.pi * 1000 * t))
            + 0.003 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _ssb_input(n, seed=2):
    """A USB tone at 0.0005 cycles (0.025 after decimation) plus noise."""
    rng = np.random.default_rng(seed)
    s = np.arange(n, dtype=np.float64)
    return (0.3 * np.exp(2j * np.pi * np.mod(0.0005 * s, 1.0))
            + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _names(p):
    return [b.name for b in p.blocks]


@pytest.mark.parametrize("chunk", [50 * 400, 50 * 1000])
def test_nfm_receiver_matches_jax(chunk):
    """nfm_receiver(50, 48 ksps audio) with fastagc on the decimated chunk,
    6 chunks: the lookahead fills two, so four carry audio."""
    kw = dict(decimation=50, audio_rate=48000,
              fastagc_block_size=chunk // 50)
    pj, pt = jrec.nfm_receiver(**kw), trec.nfm_receiver(**kw)
    assert _names(pt) == _names(pj) and pt.warmup_out == pj.warmup_out
    a, b, _, _ = _stream(pj, pt, _nfm_input(6 * chunk), chunk)
    assert b.dtype == np.float32 and np.abs(b[2 * chunk // 50:]).max() > 0.1
    assert_snr(a, b, BAR, f"nfm_receiver chunk {chunk}")


@pytest.mark.parametrize("chunk", [50 * 800, 50 * 1200])
def test_am_receiver_matches_jax(chunk):
    pj, pt = jrec.am_receiver(), trec.am_receiver()
    assert _names(pt) == _names(pj)
    a, b, _, _ = _stream(pj, pt, _am_input(2 * 50 * 1200), chunk)
    assert_snr(a, b, BAR, f"am_receiver chunk {chunk}")


@pytest.mark.parametrize("frames", [12, 18])
def test_ssb_receiver_with_agc_matches_jax(frames):
    """ssb_receiver() (agc_on=True, the default of both packages) in chunks
    of ``frames`` bandpass frames: the chain from SSB_SETTLE on; then the
    port's agc_block on csdr_tpu's own AGC input, from sample 0."""
    pj, pt = jrec.ssb_receiver(), trec.ssb_receiver()
    assert _names(pt) == _names(pj)
    chunk = 50 * pt.blocks[1].input_size * frames
    x = _ssb_input(chunk * (36 // frames))
    a, b, _, _ = _stream(pj, pt, x, chunk)
    assert len(a) - SSB_SETTLE >= 2000
    assert_snr(a[SSB_SETTLE:], b[SSB_SETTLE:], BAR,
               f"ssb_receiver frames {frames}")
    pre = jrec.ssb_receiver(agc_on=False)
    a_pre, _, _, _ = _stream(pre, trec.ssb_receiver(agc_on=False), x, chunk)
    st, y = pt.blocks[3](pt.blocks[3].init("cpu"), torch.from_numpy(a_pre))
    assert_snr(a, np.clip(y.numpy(), -1, 1), BAR,
               "agc_block on csdr_tpu's AGC input")


@pytest.mark.parametrize("which", ["nfm", "am", "ssb"])
def test_receiver_resumes_csdr_tpu_state(which):
    """csdr_tpu streams its first chunks; its state leaves (FIR tail, demod
    carry, de-emphasis tail, fastagc buffers, fastdcblock level, bandpass
    carry and taps, AGC gain/hang/started) load into the port, which
    streams the next chunks as csdr_tpu does."""
    if which == "nfm":
        n = 50 * 400
        make = {"j": lambda: jrec.nfm_receiver(50, audio_rate=48000,
                                               fastagc_block_size=n // 50),
                "t": lambda: trec.nfm_receiver(50, audio_rate=48000,
                                               fastagc_block_size=n // 50)}
        x, first = _nfm_input(5 * n), 3 * n   # past the lookahead fill
    elif which == "am":
        n = 50 * 1200
        make = {"j": jrec.am_receiver, "t": trec.am_receiver}
        x, first = _am_input(2 * n), n
    else:
        n = 50 * 178 * 12
        make = {"j": jrec.ssb_receiver, "t": trec.ssb_receiver}
        x, first = _ssb_input(2 * n), n
    pj, pt = make["j"](), make["t"]()
    _, _, sj, _ = _stream(pj, pt, x[:first], n)
    leaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(sj)]
    st = csdr_tpu_torch.state_from_jax_leaves(pt, leaves, device="cpu")
    a, b, _, _ = _stream(pj, pt, x[first:], n, sj=sj, st=st)
    assert_snr(a, b, BAR, f"resumed {which}_receiver")
