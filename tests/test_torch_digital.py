"""The digital modem ops and noise sources of csdr_tpu_torch against
csdr_tpu on the same numpy inputs: every byte-domain op bit for bit, the
DBPSK decoder bit for bit on BPSK constellations, the float ops to the
float32 rounding of their transcendentals, and the noise sources by their
statistics (the port's torch.Generator streams are not threefry's) and by
the exact amplitude split of awgn_cc."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu.core.cplx import CF
from csdr_tpu.ops import digital as jdig
from csdr_tpu.ops import noise as jnoise

from csdr_tpu_torch.ops import digital as tdig
from csdr_tpu_torch.ops import noise as tnoise

torch.set_num_threads(2)

TEXT = b"CQ CQ CQ DE HA7ILM PSE K 0123 ~{}|\x00\x7f hello, World!\n"


def _cf(x):
    x = np.asarray(x, np.complex64)
    return CF(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))


def _np(a):
    if isinstance(a, CF):
        return np.asarray(a.re) + 1j * np.asarray(a.im)
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# byte-domain ops: bit for bit
# --------------------------------------------------------------------------

def test_varicode_encoder_equal():
    text = np.frombuffer(TEXT, np.uint8)
    np.testing.assert_array_equal(tdig.psk31_varicode_encoder_u8_u8(text),
                                  jdig.psk31_varicode_encoder_u8_u8(text))


@pytest.mark.parametrize("max_out,skip", [(None, 0), (12, 0), (None, 37)])
def test_varicode_decoder_equal(max_out, skip):
    rng = np.random.default_rng(1)
    bits = jdig.psk31_varicode_encoder_u8_u8(np.frombuffer(TEXT, np.uint8))
    bits = np.concatenate([rng.integers(0, 2, 23), bits,
                           rng.integers(0, 2, 40)]).astype(np.uint8)
    j = jdig.psk31_varicode_decoder_u8_u8(bits, max_out, skip)
    t = tdig.psk31_varicode_decoder_u8_u8(_t(bits), max_out, skip)
    assert int(t.count) == int(j.count) > 0
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    if max_out is None and skip == 0:
        assert TEXT[3:] in bytes(t.compact().numpy())


def _rtty_symbols(rng, n_chars):
    """Start bit 0, five data bits, stop bits 1, with random idle gaps."""
    out = []
    for _ in range(n_chars):
        out += [1] * int(rng.integers(1, 4))
        out += [0] + list(rng.integers(0, 2, 5)) + [1, 1]
    return np.asarray(out, np.uint8)


def test_rtty_baudot_decoder_equal_streamed():
    rng = np.random.default_rng(2)
    sym = _rtty_symbols(rng, 40)
    half = len(sym) // 2
    js, ts = None, None
    for part in (sym[:half], sym[half:]):
        jo, js = jdig.rtty_baudot_decoder(part, state=js)
        to, ts = tdig.rtty_baudot_decoder(_t(part), state=ts)
        assert int(to.count) == int(jo.count)
        np.testing.assert_array_equal(to.data.numpy(), np.asarray(jo.data))
        for a, b in zip(ts, js):
            assert int(a) == int(b)
    # a batch of two streams: each row as alone
    rows = np.stack([sym[:120], _rtty_symbols(rng, 40)[:120]])
    tb, _ = tdig.rtty_baudot_decoder(_t(rows))
    for r in range(2):
        jo, _ = jdig.rtty_baudot_decoder(rows[r])
        assert int(tb.count[r]) == int(jo.count)
        np.testing.assert_array_equal(tb.data[r].numpy(), np.asarray(jo.data))


@pytest.mark.parametrize("fig_mode", [0, 1])
def test_rtty_baudot2ascii_equal(fig_mode):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 32, 300).astype(np.uint8)
    codes[[5, 90, 200]] = [27, 31, 27]          # mode selects
    jo, jm = jdig.rtty_baudot2ascii_u8_u8(codes, fig_mode)
    to, tm = tdig.rtty_baudot2ascii_u8_u8(_t(codes), fig_mode)
    assert int(to.count) == int(jo.count) and int(tm) == int(jm)
    np.testing.assert_array_equal(to.data.numpy(), np.asarray(jo.data))


def test_slicers_and_bit_plumbing_equal():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-1.5, 1.5, 500),
                        [-1.0, -1 / 3, 0.0, 1 / 3, 1.0, 0.5, -0.5]]
                       ).astype(np.float32)
    np.testing.assert_array_equal(tdig.binary_slicer_f_u8(_t(x)).numpy(),
                                  np.asarray(jdig.binary_slicer_f_u8(x)))
    for n_sym in (2, 4, 5):
        np.testing.assert_array_equal(
            tdig.generic_slicer_f_u8(_t(x), n_sym).numpy(),
            np.asarray(jdig.generic_slicer_f_u8(jnp.asarray(x), n_sym)))
    b = rng.integers(0, 256, 64).astype(np.uint8)
    np.testing.assert_array_equal(tdig.pack_bits_1to8_u8_u8(_t(b)).numpy(),
                                  np.asarray(jdig.pack_bits_1to8_u8_u8(b)))
    bits = rng.integers(0, 3, 512).astype(np.uint8)
    np.testing.assert_array_equal(tdig.pack_bits_8to1_u8_u8(_t(bits)).numpy(),
                                  np.asarray(jdig.pack_bits_8to1_u8_u8(bits)))
    np.testing.assert_array_equal(tdig.invert_u8_u8(_t(bits)).numpy(),
                                  np.asarray(jdig.invert_u8_u8(bits)))
    np.testing.assert_array_equal(
        tdig.duplicate_samples_ntimes_u8_u8(_t(b), 4, 3).numpy(),
        np.asarray(jdig.duplicate_samples_ntimes_u8_u8(jnp.asarray(b), 4, 3)))


@pytest.mark.parametrize("state", [0, 1])
def test_differential_codec_equal(state):
    rng = np.random.default_rng(5 + state)
    bits = rng.integers(0, 2, 257).astype(np.uint8)
    je, jl = jdig.differential_codec_encode(bits, state)
    te, tl = tdig.differential_codec_encode(_t(bits), state)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert int(tl) == int(jl)
    jd, jl = jdig.differential_codec_decode(np.asarray(je), state)
    td, tl = tdig.differential_codec_decode(te, state)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert int(tl) == int(jl)
    np.testing.assert_array_equal(td.numpy()[1:], bits[1:])


def test_serial_line_decoder_and_pattern_search_equal():
    rng = np.random.default_rng(7)
    spb = 8.0
    frames = []
    for byte in rng.integers(0, 256, 20):
        bits = [-1.0] + [1.0 if (byte >> (7 - k)) & 1 else -1.0
                         for k in range(8)] + [1.0, 1.0]
        frames += list(np.repeat(bits, int(spb)))
    x = np.asarray([1.0] * 5 + frames, np.float32)
    x += 0.1 * rng.standard_normal(len(x)).astype(np.float32)
    to, tu = tdig.serial_line_decoder_f_u8(x, spb)
    jo, ju = jdig.serial_line_decoder_f_u8(x, spb)
    np.testing.assert_array_equal(to, jo)
    assert tu == ju and len(to) > 10
    stream = rng.integers(0, 4, 400).astype(np.uint8)
    pat = np.asarray([1, 2, 3], np.uint8)
    np.testing.assert_array_equal(tdig.pattern_search_u8_u8(stream, pat, 4),
                                  jdig.pattern_search_u8_u8(stream, pat, 4))


# --------------------------------------------------------------------------
# complex ops
# --------------------------------------------------------------------------

def _bpsk_symbols(rng, n):
    enc, _ = jdig.differential_codec_encode(rng.integers(0, 2, n))
    return np.asarray(enc)


def test_psk_modulator_and_interpolation_close():
    rng = np.random.default_rng(8)
    enc = _bpsk_symbols(rng, 200)
    for n_psk, sym in ((2, enc), (4, rng.integers(0, 4, 200))):
        j = _np(jdig.psk_modulator_u8_c(sym, n_psk))
        t = tdig.psk_modulator_u8_c(_t(sym.astype(np.uint8)), n_psk).numpy()
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-7)
    x = (rng.standard_normal(50) + 1j * rng.standard_normal(50)
         ).astype(np.complex64)
    last = np.complex64(0.3 - 0.2j)
    jy, jl = jdig.psk31_interpolate_sine_cc(
        _cf(x), 32, CF(jnp.float32(last.real), jnp.float32(last.imag)))
    ty, tl = tdig.psk31_interpolate_sine_cc(_t(x), 32, torch.tensor(last))
    # XLA fuses one of the two products into an FMA: one rounding apart
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=0, atol=1e-6)
    assert complex(tl) == complex(_np(jl))
    # a batch of rows: each row as alone
    tb, _ = tdig.psk31_interpolate_sine_cc(_t(np.stack([x, x[::-1]])), 32)
    t0, _ = tdig.psk31_interpolate_sine_cc(_t(x[::-1].copy()), 32)
    np.testing.assert_array_equal(tb[1].numpy(), t0.numpy())


def test_dbpsk_decoder_bit_exact_on_bpsk():
    rng = np.random.default_rng(9)
    enc = _bpsk_symbols(rng, 300)
    sym = _np(jdig.psk_modulator_u8_c(enc, 2)).astype(np.complex64)
    # rotated, noisy constellation points (the TED's symbols look so)
    sym = (sym * np.exp(0.3j) * rng.uniform(0.5, 1.5, 300)
           + 0.05 * (rng.standard_normal(300)
                     + 1j * rng.standard_normal(300))).astype(np.complex64)
    jb, jl = jdig.dbpsk_decoder_c_u8(_cf(sym))
    tb, tl = tdig.dbpsk_decoder_c_u8(_t(sym))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert complex(tl) == complex(_np(jl))
    # the count= form: a padded chunk carries its last VALID symbol
    for count in (0, 1, 170):
        padded = sym.copy()
        padded[count:] = 0
        last = np.complex64(-0.7 + 0.1j)
        jlast = CF(jnp.float32(last.real), jnp.float32(last.imag))
        jb, jl = jdig.dbpsk_decoder_c_u8(_cf(padded), jlast,
                                         count=jnp.int32(count))
        tb, tl = tdig.dbpsk_decoder_c_u8(_t(padded), torch.tensor(last),
                                         count=torch.tensor(count))
        np.testing.assert_array_equal(tb.numpy()[:count],
                                      np.asarray(jb)[:count])
        assert complex(tl) == complex(_np(jl))
    # rows with their own counts, as the bank calls it
    rows = np.stack([sym[:100], sym[100:200]])
    counts = torch.tensor([60, 0], dtype=torch.int32)
    _, tl = tdig.dbpsk_decoder_c_u8(_t(rows), torch.zeros(2, dtype=torch
                                                          .complex64),
                                    count=counts)
    assert complex(tl[0]) == complex(sym[59]) and complex(tl[1]) == 0


def test_normalized_timing_variance_close():
    rng = np.random.default_rng(10)
    idx = (np.arange(300) * 32 + 5 + rng.integers(-6, 7, 300)).astype(
        np.int32)
    j = float(jdig.normalized_timing_variance_u32_f(idx, 32, 5))
    t = float(tdig.normalized_timing_variance_u32_f(_t(idx), 32, 5))
    assert t == pytest.approx(j, rel=1e-5)


# --------------------------------------------------------------------------
# noise sources
# --------------------------------------------------------------------------

N_NOISE = 200_000


def test_uniform_and_gaussian_statistics():
    u = tnoise.uniform_noise_f(N_NOISE, seed=3, device="cpu").numpy()
    assert u.dtype == np.float32 and u.min() >= -1.0 and u.max() < 1.0
    assert abs(u.mean()) < 0.01 and abs(u.var() - 1 / 3) < 0.01
    g = tnoise.gaussian_noise_c(N_NOISE, seed=3, device="cpu").numpy()
    assert g.dtype == np.complex64
    for part in (g.real, g.imag):
        assert abs(part.mean()) < 0.01 and abs(part.var() - 1.0) < 0.02
    assert abs(np.mean(g.real * g.imag)) < 0.01
    # a seed gives one stream; another seed another
    g2 = tnoise.gaussian_noise_c(N_NOISE, seed=3, device="cpu").numpy()
    np.testing.assert_array_equal(g, g2)
    assert not np.array_equal(
        g, tnoise.gaussian_noise_c(N_NOISE, seed=4, device="cpu").numpy())
    # the same statistics as csdr_tpu's threefry stream
    gj = _np(jnoise.gaussian_noise_c(N_NOISE, seed=3))
    assert abs(np.mean(np.abs(g) ** 2) - np.mean(np.abs(gj) ** 2)) < 0.04


@pytest.mark.parametrize("snr_db", [0.0, 10.0, 20.0])
def test_awgn_power_and_exact_amplitude_split(snr_db, monkeypatch):
    r = 10.0 ** (snr_db / 20.0)
    a_noise = 0.707 / (r + 1.0)
    zero = torch.zeros(N_NOISE, dtype=torch.complex64)
    out = tnoise.awgn_cc(zero, snr_db, seed=1).numpy()
    # complex noise power 2 * a_noise^2 (0.707 per component)
    assert np.mean(np.abs(out) ** 2) == pytest.approx(2 * a_noise ** 2,
                                                      rel=0.02)
    nz = tnoise.gaussian_noise_c(N_NOISE, 1, "cpu").numpy()
    np.testing.assert_array_equal(out.real, nz.real * np.float32(a_noise))
    # zero noise: the signal's share bit for bit as csdr_tpu's
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
         ).astype(np.complex64)
    monkeypatch.setattr(jnoise, "gaussian_noise_c", lambda n, seed: CF(
        jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32)))
    monkeypatch.setattr(tnoise, "gaussian_noise_c",
                        lambda n, seed, device: torch.zeros(
                            n, dtype=torch.complex64, device=device))
    j = _np(jnoise.awgn_cc(_cf(x), snr_db))
    t = tnoise.awgn_cc(_t(x), snr_db).numpy()
    np.testing.assert_array_equal(t, j)


def test_constant_and_repeat_sources_equal():
    np.testing.assert_array_equal(
        tnoise.yes_f(0.25, 100, device="cpu").numpy(),
        np.asarray(jnoise.yes_f(0.25, 100)))
    pat = np.asarray([1, 2, 250], np.uint8)
    np.testing.assert_array_equal(
        tnoise.repeat_u8(pat, 7, device="cpu").numpy(),
        np.asarray(jnoise.repeat_u8(pat, 7)))
    x = np.arange(10, dtype=np.float32)
    np.testing.assert_array_equal(
        tnoise.add_n_zero_samples_at_beginning_f(_t(x), 5).numpy(),
        np.asarray(jnoise.add_n_zero_samples_at_beginning_f(
            jnp.asarray(x), 5)))
