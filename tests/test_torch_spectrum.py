"""The spectrum/waterfall path of csdr_tpu_torch against csdr_tpu: the FFT
framing block in both modes streamed at three chunk sizes, against both of
csdr_tpu's FFT routes (its Stockham FFT by default, its kernel-order Pallas
FFT under CSDR_PALLAS_INTERPRET=1), the real-input block, rfft, the power
and log ops, and the waterfall and BASELINE config-1 chains whole, from raw
u8 I/Q bytes.

Tolerances.  Spectra (complex): >= 90 dB SNR, csdr_tpu's own bar between
its kernel and its fallback (tests/test_fftfilt.py); its Pallas FFT runs
in bf16x3 (~108 dB here), its Stockham FFT in float32 (~137 dB).  dB rows:
compared on bins within 100 dB of their row's peak, where a bin's float32
rounding (relative 1e-7 of the row's peak amplitude after an FFT) moves its
dB value by at most ~1e-2; the linear averaged power also as an SNR.
Bytes: the port's codec on csdr_tpu's dB rows or s16 audio is csdr_tpu's
bit for bit; the bytes of two whole chains need not be, since one LSB of
a dB value at x100 or of the audio changes the rest of a codec stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu.core import cplx as jcplx
from csdr_tpu.core import fft as jfft
from csdr_tpu.core.block import Pipeline as JPipeline
from csdr_tpu.core.block import stateless as jstateless
from csdr_tpu.core.stream import run_offline as jrun_offline
from csdr_tpu.models import wfm as jwfm
from csdr_tpu.ops import adpcm as jadpcm
from csdr_tpu.ops import convert as jconv
from csdr_tpu.ops import spectrum as jspec

import csdr_tpu_torch
from csdr_tpu_torch import run_offline
from csdr_tpu_torch.core import fft as tfft
from csdr_tpu_torch.core.block import Pipeline, stateless
from csdr_tpu_torch.kernels import fft_cuda
from csdr_tpu_torch.models import wfm as twfm
from csdr_tpu_torch.ops import adpcm as tadpcm
from csdr_tpu_torch.ops import convert as tconv
from csdr_tpu_torch.ops import spectrum as tspec

from tests.util import assert_snr, cplx_noise, real_noise

torch.set_num_threads(2)

SPEC_BAR = 90.0


def _tones_u8(n: int, freqs, seed: int, noise: float = 0.05) -> np.ndarray:
    """Tones at ``freqs`` (cycles/sample) plus noise, quantised to
    interleaved u8 I/Q as an RTL-SDR delivers it."""
    rng = np.random.default_rng(seed)
    s = np.arange(n, dtype=np.float64)
    x = noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for k, f in enumerate(freqs):
        x += 0.2 / (k + 1) * np.exp(2j * np.pi * np.mod(f * s, 1.0))
    iq = np.stack([x.real, x.imag], axis=1).reshape(-1)
    return np.clip(np.round(127.5 + 127.5 * iq), 0, 255).astype(np.uint8)


def _stream(jb, tb, x, n, sj=None, st=None):
    """Both blocks over ``x`` in chunks of ``n``; csdr_tpu's apply jitted
    once per chunk shape, as its stream runner runs it."""
    apply = jax.jit(jb.apply)
    sj = jb.init() if sj is None else sj
    st = tb.init("cpu") if st is None else st
    oj, ot = [], []
    for c in range(len(x) // n):
        chunk = x[c * n:(c + 1) * n]
        xj = (jcplx.from_numpy(chunk) if np.iscomplexobj(chunk)
              else jnp.asarray(chunk))
        sj, yj = apply(sj, xj)
        with torch.no_grad():
            st, yt = tb(st, torch.from_numpy(chunk))
        oj.append(jcplx.to_numpy(yj) if isinstance(yj, jcplx.CF)
                  else np.asarray(yj))
        ot.append(yt.numpy())
    return np.concatenate(oj), np.concatenate(ot), sj, st


def _db_close(ref, test, what, tol=0.01, span=100.0):
    """dB rows equal within ``tol`` dB on every bin within ``span`` dB of
    its row's peak."""
    ref, test = np.atleast_2d(ref), np.atleast_2d(test)
    keep = ref >= ref.max(axis=-1, keepdims=True) - span
    err = np.abs(ref - test)[keep]
    assert keep.mean() > 0.5 and err.max() <= tol, \
        f"{what}: {err.max()} dB on {keep.sum()} bins"


# (fft_size, every_n, chunk sizes): overlapped with every_n dividing
# fft_size, overlapped without (the waterfall's case), and skip mode
FRAMINGS = [(256, 128, (128, 384, 1024)), (512, 384, (384, 1152, 1536)),
            (256, 384, (384, 768, 1920))]


@pytest.mark.parametrize("interpret", [None, "1"], ids=["stockham",
                                                        "jax_kernel"])
@pytest.mark.parametrize("fft,every_n,chunks", FRAMINGS,
                         ids=["overlap", "overlap_ragged", "skip"])
def test_fft_cc_block_streams_like_jax(monkeypatch, fft, every_n, chunks,
                                       interpret):
    if interpret:
        monkeypatch.setenv("CSDR_PALLAS_INTERPRET", interpret)
    x = cplx_noise(3840, seed=fft + every_n)
    for n in chunks:
        jb, tb = jspec.fft_cc_block(fft, every_n), tspec.fft_cc_block(fft,
                                                                      every_n)
        a, b, sj, st = _stream(jb, tb, x, n)
        assert b.shape == a.shape == ((len(x) // n) * (n // every_n), fft)
        assert_snr(a, b, SPEC_BAR, f"fft_cc {fft}/{every_n} chunk {n}")
        assert st.shape == (max(fft - every_n, 0),)
        if st.numel():
            np.testing.assert_array_equal(st.numpy(), jcplx.to_numpy(sj))


def test_fft_cc_resumes_from_jax_state():
    """csdr_tpu runs chunk 1; its overlap tail (planar re, im) loads into
    the port's block, which continues the stream as csdr_tpu does."""
    x = cplx_noise(3 * 1152, seed=3)
    jb, tb = jspec.fft_cc_block(512, 384), tspec.fft_cc_block(512, 384)
    sj, _ = jax.jit(jb.apply)(jb.init(), jcplx.from_numpy(x[:1152]))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(sj)]
    st = csdr_tpu_torch.state_from_jax_leaves(tb, leaves, device="cpu")
    assert st.dtype == torch.complex64 and st.shape == (128,)
    a, b, _, _ = _stream(jb, tb, x[1152:], 1152, sj, st)
    assert_snr(a, b, SPEC_BAR, "fft_cc resumed")


def test_fft_natural_is_torch_fft_on_cpu():
    x = torch.from_numpy(cplx_noise(4 * 512, seed=4).reshape(4, 512))
    assert torch.equal(fft_cuda.fft_natural(x), torch.fft.fft(x))
    ko = fft_cuda.fft_ko(x)
    assert torch.equal(fft_cuda.ko_to_natural(ko), torch.fft.fft(x))
    with pytest.raises(ValueError):
        fft_cuda.fft_natural(x[:, :64])


def test_fft_fc_block_and_rfft_match_jax():
    x = real_noise(4 * 640, seed=5)
    a, b, _, _ = _stream(jspec.fft_fc_block(256, 640),
                         tspec.fft_fc_block(256, 640), x, 1280)
    assert b.shape == (4, 256)
    assert_snr(a, b, SPEC_BAR, "fft_fc")
    r = real_noise(1024, seed=6)
    assert_snr(jcplx.to_numpy(jfft.rfft(jnp.asarray(r))),
               tfft.rfft(torch.from_numpy(r)).numpy(), SPEC_BAR, "rfft")


def test_power_and_log_ops_match_jax():
    """On the same complex values: |x|^2 products and sums are float32 in
    both (SNR >= 130 dB, a few float32 roundings), log10 differs by its
    implementations' last bits (<= 1e-4 dB)."""
    x = cplx_noise(8 * 128, seed=7).reshape(8, 128)
    xj, xt = jcplx.from_numpy(x), torch.from_numpy(x)
    _db_close(np.asarray(jspec.logpower_cf(xj, -20.0)),
              tspec.logpower_cf(xt, -20.0).numpy(), "logpower_cf", 1e-4)
    acc = np.abs(x) ** 2
    assert_snr(np.asarray(jspec.accumulate_power_cf(xj, jnp.asarray(acc))),
               tspec.accumulate_power_cf(xt, torch.from_numpy(acc)).numpy(),
               130, "accumulate_power_cf")
    p = acc.astype(np.float32)
    _db_close(np.asarray(jspec.log_ff(jnp.asarray(p), 3.0)),
              tspec.log_ff(torch.from_numpy(p), 3.0).numpy(), "log_ff", 1e-4)
    tj = float(jspec.total_logpower_cf(xj))
    tt = float(tspec.total_logpower_cf(xt))
    assert abs(tj - tt) < 1e-4
    sides = np.arange(24, dtype=np.float32).reshape(2, 12)
    np.testing.assert_array_equal(
        tspec.fft_exchange_sides_ff(torch.from_numpy(sides)).numpy(),
        np.asarray(jspec.fft_exchange_sides_ff(jnp.asarray(sides))))
    np.testing.assert_array_equal(
        tspec.fft_one_side_ff(torch.from_numpy(sides)).numpy(),
        np.asarray(jspec.fft_one_side_ff(jnp.asarray(sides))))


@pytest.mark.parametrize("avg", [1, 4, 10])
def test_logaveragepower_matches_jax(avg):
    """The add_db - 10*log10(avg) offset rounded to float32 once, as it
    enters csdr_tpu's program."""
    sp = cplx_noise(20 * 256, seed=avg).reshape(20, 256)
    j = np.asarray(jspec.logaveragepower_cf(jcplx.from_numpy(sp), -70.0, avg))
    t = tspec.logaveragepower_cf(torch.from_numpy(sp), -70.0, avg).numpy()
    assert t.dtype == np.float32 and t.shape == (20 // avg, 256)
    _db_close(j, t, f"logaveragepower avg={avg}", 1e-4)
    jb = jspec.logaveragepower_block(-70.0, 256, avg)
    tb = tspec.logaveragepower_block(-70.0, 256, avg)
    _, yj = jb.apply(None, jcplx.from_numpy(sp))
    _, yt = tb(None, torch.from_numpy(sp))
    _db_close(np.asarray(yj), yt.numpy(), "logaveragepower_block", 1e-4)


def _waterfall(pkg, fft, every_n, avg):
    """convert_u8_c -> fft_cc -> logaveragepower -> fft_exchange_sides_ff:
    the dB rows; the compression runs on them apart."""
    conv, spec = (jconv, jspec) if pkg == "jax" else (tconv, tspec)
    pipe_cls, stl = (JPipeline, jstateless) if pkg == "jax" else \
        (Pipeline, stateless)
    return pipe_cls([
        stl("convert_u8_c", conv.convert_u8_c),
        spec.fft_cc_block(fft, every_n),
        spec.logaveragepower_block(-70.0, fft, avg),
        stl("fft_exchange_sides_ff",
            lambda x: spec.fft_exchange_sides_ff(x.reshape(-1, fft))),
    ], name="waterfall")


@pytest.mark.parametrize("interpret", [None, "1"], ids=["stockham",
                                                        "jax_kernel"])
def test_waterfall_chain_from_u8_matches_jax(monkeypatch, interpret):
    """The waterfall at a small size (fft 512, every_n 384, avg 4) from raw
    u8 I/Q through both packages' run_offline: tones in their columns,
    dB rows and linear power against csdr_tpu, and the port's compression
    of csdr_tpu's dB rows equal to csdr_tpu's bytes."""
    if interpret:
        monkeypatch.setenv("CSDR_PALLAS_INTERPRET", interpret)
    fft, every_n, avg = 512, 384, 4
    freqs = (-0.3, 0.1, 0.22)
    b = _tones_u8(3 * 8 * every_n, freqs, seed=11)
    block = 2 * 8 * every_n                     # bytes: 8 frames, 2 rows
    rows_j = jrun_offline(_waterfall("jax", fft, every_n, avg), b, block)
    rows_t = run_offline(_waterfall("torch", fft, every_n, avg), b, block,
                         device="cpu")
    assert rows_t.shape == rows_j.shape == (6, fft)
    for f in freqs:
        col = (round(f * fft) + fft // 2) % fft
        assert np.all(np.abs(np.argmax(rows_t[:, col - 3:col + 4], 1) - 3)
                      <= 1)
    _db_close(rows_j, rows_t, "waterfall dB rows", 0.01)
    assert_snr(10 ** (rows_j / 10), 10 ** (rows_t / 10), 100,
               "waterfall linear power")
    bj = np.asarray(jspec.compress_fft_adpcm_rows(jnp.asarray(rows_j), fft))
    bt = tspec.compress_fft_adpcm_rows(torch.from_numpy(rows_j), fft)
    np.testing.assert_array_equal(bt.numpy(), bj)


def test_config1_chain_from_u8_matches_jax():
    """BASELINE config 1 with OpenWebRX's ADPCM audio from raw u8 I/Q:
    convert_u8_c -> wfm_basic -> convert_f_s16 -> encode_block, chunk by
    chunk.  Audio against csdr_tpu >= 60 dB (the WFM bar); convert_f_s16
    and the encoder on csdr_tpu's audio bit for bit; the bytes decode to
    the 1 kHz tone."""
    fs, n = 240_000, 24_000
    t = np.arange(4 * n) / fs
    phase = 2 * np.pi * np.cumsum(0.5 * np.sin(2 * np.pi * 1000 * t)) \
        * 75_000 / fs
    iq = np.stack([np.cos(phase), np.sin(phase)], 1).reshape(-1)
    b = np.clip(np.round(127.5 + 120 * iq), 0, 255).astype(np.uint8)
    jfront = JPipeline([jstateless("convert_u8_c", jconv.convert_u8_c),
                        *jwfm.wfm_basic().blocks])
    tfront = Pipeline([stateless("convert_u8_c", tconv.convert_u8_c),
                       twfm.wfm_basic()])
    apply = jax.jit(jfront.apply)
    sj, st = jfront.init(), tfront.init("cpu")
    enc = tadpcm.paired_encode_block()
    se = enc.init("cpu")
    aj, at, sent = [], [], []
    for c in range(4):
        chunk = b[2 * c * n: 2 * (c + 1) * n]
        sj, yj = apply(sj, jnp.asarray(chunk))
        st, yt = tfront(st, torch.from_numpy(chunk))
        assert yt.count == int(yj.count)
        aj.append(np.asarray(yj.data)[: int(yj.count)])
        audio = yt.compact()
        at.append(audio.numpy())
        se, y = enc(se, tconv.convert_f_s16(audio))
        sent.append(y)
    aj, at = np.concatenate(aj), np.concatenate(at)
    assert_snr(aj, at, 60, "config 1 audio")
    sj16 = np.asarray(jconv.convert_f_s16(jnp.asarray(aj)))
    s16 = tconv.convert_f_s16(torch.from_numpy(aj)).numpy()
    np.testing.assert_array_equal(s16, sj16)
    even = len(sj16) // 2 * 2
    np.testing.assert_array_equal(
        tadpcm.encode_ima_adpcm(torch.from_numpy(s16[:even]))[0].numpy(),
        np.asarray(jadpcm.encode_ima_adpcm(jnp.asarray(sj16[:even]))[0]))
    dec, _ = tadpcm.decode_ima_adpcm(torch.cat(sent))
    seg = dec.numpy()[2000:].astype(np.float64)
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    assert abs(np.argmax(spec) * 48_000 / len(seg) - 1000) < 5
