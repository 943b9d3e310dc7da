"""The WFM stages and receivers of csdr_tpu_torch against csdr_tpu, streamed
chunk by chunk with the same chunking in both packages.  VarOut counts
must be equal exactly: a count depends only on the state and the chunk
length, so any difference is a framing fault."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu import firdes
from csdr_tpu.core import cplx as jcplx
from csdr_tpu.core.block import VarOut as JVarOut
from csdr_tpu.models import wfm as jwfm
from csdr_tpu.ops import demod as jdemod
from csdr_tpu.ops import resamp as jresamp

from csdr_tpu_torch.core.block import VarOut as TVarOut
from csdr_tpu_torch.models import wfm as twfm
from csdr_tpu_torch.ops import demod as tdemod
from csdr_tpu_torch.ops import resamp as tresamp

from tests.util import assert_snr, cplx_noise, real_noise

torch.set_num_threads(2)


def _fm_tone(fs, n, carrier=0.0, dev=75_000.0, tone=1000.0, amp=0.5):
    """The verify skill's FM-modulated 1 kHz tone, optionally on a carrier
    at ``carrier``*fs."""
    t = np.arange(n) / fs
    audio = amp * np.sin(2 * np.pi * tone * t)
    phase = 2 * np.pi * (np.cumsum(audio) * dev / fs
                         + np.mod(carrier * np.arange(n), 1.0))
    return np.exp(1j * phase).astype(np.complex64)


def _stream(pj, pt, x, n):
    """Feed both packages the same chunks; returns (jax_out, port_out,
    jax_counts, port_counts)."""
    sj, st = pj.init(), pt.init("cpu")
    oj, ot, cj, ct = [], [], [], []
    for c in range(len(x) // n):
        chunk = x[c * n:(c + 1) * n]
        xj = (jcplx.from_numpy(chunk) if np.iscomplexobj(chunk)
              else jnp.asarray(chunk))
        sj, yj = pj.apply(sj, xj)
        with torch.no_grad():
            st, yt = pt(st, torch.from_numpy(chunk))
        if isinstance(yj, JVarOut):
            assert isinstance(yt, TVarOut)
            assert yt.data.shape[0] == yj.data.shape[0]   # same capacity
            cj.append(int(yj.count))
            ct.append(yt.count)
            yj, yt = np.asarray(yj.data)[: cj[-1]], yt.compact()
        elif isinstance(yj, jcplx.CF):
            yj = jcplx.to_numpy(yj)
        oj.append(np.asarray(yj))
        ot.append(yt.numpy())
    return np.concatenate(oj), np.concatenate(ot), cj, ct


# --------------------------------------------------------------------------
# stages (bars of tests/test_demod.py and tests/test_wfm.py)
# --------------------------------------------------------------------------

def test_fmdemod_quadri_streams_like_jax():
    x = cplx_noise(3 * 4000, seed=1)
    x[5] = 0                                   # the den != 0 guard
    a, b, _, _ = _stream(jdemod.fmdemod_quadri_block(),
                         tdemod.fmdemod_quadri_block(), x, 4000)
    assert np.all(np.isfinite(b)) and b[5] == 0
    assert_snr(a, b, 90, "fmdemod_quadri")


@pytest.mark.parametrize("sample_rate,fir_form", [(48_000, True),
                                                  (2_400_000, False)])
def test_deemphasis_wfm_streams_like_jax(sample_rate, fir_form):
    assert tdemod.deemphasis_wfm_block(50e-6, sample_rate).use_fir \
        == fir_form                            # 53-tap FIR or the scan
    x = real_noise(3 * 5000, seed=2)
    a, b, _, _ = _stream(jdemod.deemphasis_wfm_block(50e-6, sample_rate),
                         tdemod.deemphasis_wfm_block(50e-6, sample_rate),
                         x, 5000)
    assert_snr(a, b, 90, "deemphasis_wfm")


@pytest.mark.parametrize("sample_rate", [48_000, 2_400_000])
def test_deemphasis_wfm_varout_carry_like_jax(sample_rate):
    """VarOut input: only the valid prefix feeds the carried state."""
    bj = jdemod.deemphasis_wfm_block(50e-6, sample_rate)
    bt = tdemod.deemphasis_wfm_block(50e-6, sample_rate)
    sj, st = bj.init(), bt.init("cpu")
    x = real_noise(3 * 5000, seed=3)
    for c, count in enumerate((4000, 4990, 0, 3117)):
        chunk = x[(c % 3) * 5000:(c % 3 + 1) * 5000]
        sj, yj = bj.apply(sj, JVarOut(jnp.asarray(chunk), jnp.int32(count)))
        st, yt = bt(st, TVarOut(torch.from_numpy(chunk), count))
        assert yt.count == int(yj.count) == count
        if count:
            assert_snr(np.asarray(yj.data)[:count], yt.compact().numpy(), 90,
                       f"varout chunk {c}")
    assert_snr(np.asarray(sj), st.numpy(), 90, "carried state")


@pytest.mark.parametrize("rate,kw,bar", [
    (5.0, {}, 90),                              # integer: the main path
    (2.4, {}, 90),                              # rational 12/5
    (2.4, {"rational": False}, 90),             # generic Lagrange
    (3.5, {"taps": firdes.firdes_lowpass_f(41, 0.08)}, 85),  # + prefilter
], ids=["integer5", "rational2.4", "generic2.4", "prefilter3.5"])
@pytest.mark.parametrize("chunk", [5000, 246])
def test_fractional_decimator_streams_like_jax(rate, kw, bar, chunk):
    rng = np.random.default_rng(7)
    x = np.convolve(rng.standard_normal(12 * chunk if chunk < 1000
                                        else 4 * chunk),
                    np.ones(8) / 8, "same").astype(np.float32)
    bj = jresamp.fractional_decimator_block(rate, 12, **kw)
    bt = tresamp.fractional_decimator_block(rate, 12, **kw)
    a, b, cj, ct = _stream(bj, bt, x, chunk)
    assert ct == cj, (ct, cj)
    assert len(a) > 0
    assert_snr(a, b, bar, f"fractional decimator {rate} {list(kw)}")


def test_rational_decimator_backlog_drains_like_jax():
    """rate 2.4 in 246-sample chunks: the cap = n/rate + den + 2 rule lets
    each chunk drain the den-quantized backlog; occupancy stays bounded."""
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal(246 * 40)).astype(np.float32)
    bt = tresamp.fractional_decimator_block(2.4)
    bj = jresamp.fractional_decimator_block(2.4)
    sj, st = bj.init(), bt.init("cpu")
    for i in range(40):
        chunk = x[i * 246:(i + 1) * 246]
        sj, yj = bj.apply(sj, jnp.asarray(chunk))
        st, yt = bt(st, torch.from_numpy(chunk))
        assert yt.count == int(yj.count)
        assert int(st[1]) == int(sj[1]) <= st[0].shape[0]
        assert float(st[2]) == float(sj[2])


# --------------------------------------------------------------------------
# the slice: whole receivers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fuse_shift", [True, False])
@pytest.mark.parametrize("chunk", [6400, 12_800, 7010])
def test_wfm_advanced_streams_like_jax(fuse_shift, chunk):
    x = _fm_tone(2_400_000, 25_640, carrier=0.2)
    a, b, cj, ct = _stream(jwfm.wfm_advanced(shift_rate=-0.2,
                                             fuse_shift=fuse_shift),
                           twfm.wfm_advanced(shift_rate=-0.2,
                                             fuse_shift=fuse_shift),
                           x, chunk)
    assert ct == cj and len(a) > 400
    assert_snr(a, b, 60, "wfm_advanced")
    np.testing.assert_allclose(b, a, rtol=2e-3, atol=5e-4)


@pytest.mark.parametrize("chunk", [2400, 6000, 7001])
def test_wfm_basic_streams_like_jax(chunk):
    x = _fm_tone(240_000, 24_000)
    a, b, cj, ct = _stream(jwfm.wfm_basic(), twfm.wfm_basic(), x, chunk)
    assert ct == cj and len(a) > 4000
    assert_snr(a, b, 60, "wfm_basic")
    np.testing.assert_allclose(b, a, rtol=2e-3, atol=5e-4)


def test_wfm_fused_switch(monkeypatch):
    monkeypatch.setenv("CSDR_WFM_FUSED", "0")
    assert twfm.wfm_advanced().blocks[0].name == "shift_cc"
    monkeypatch.setenv("CSDR_WFM_FUSED", "1")
    assert twfm.wfm_advanced().blocks[0].name == "shift_fir_decimate_cc"


def test_wfm_advanced_recovers_the_tone_on_cpu():
    from csdr_tpu_torch import run_offline
    x = _fm_tone(2_400_000, 240_000, carrier=0.2)
    audio = run_offline(twfm.wfm_advanced(shift_rate=-0.2), x,
                        block_size=48_000, device="cpu")
    seg = audio[2000:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    assert abs(np.argmax(spec) * 48_000 / len(seg) - 1000) < 5
