"""Filter design (host-side NumPy; runs once at pipeline init).

The PyTorch port's own copy of csdr_tpu.firdes, kept bit-identical to it,
with the NFM de-emphasis tables (ops/_nfm_deemph_tables.py).

Mirrors the reference's tap math exactly so that filters match bit-for-bit in
float32 (SURVEY.md §2.2):

- window kernels             -> reference libcsdr.c:76-104
- windowed-sinc lowpass      -> reference libcsdr.c:127-142 (firdes_lowpass_f)
- complex bandpass           -> reference libcsdr.c:144-167 (firdes_bandpass_c)
- filter length rule         -> reference libcsdr.c:169-174 (firdes_filter_len)
- resampler lowpass          -> reference libcsdr.c:664-673
- peak filter                -> reference libcsdr.c:2232-2272 (firdes_add_peak_c)
- RRC / cosine matched filters -> reference libcsdr.c:2455-2497
- NFM de-emphasis FIR        -> reference predefined.h:41-68

Design is float64 internally and cast to float32 at the end, which matches the
reference (C ``sin``/``cos`` are double; taps are stored into float arrays).
"""

from __future__ import annotations

import numpy as np

BOXCAR = "BOXCAR"
HAMMING = "HAMMING"
BLACKMAN = "BLACKMAN"
WINDOW_DEFAULT = HAMMING


def window_kernel(window: str, rate):
    """Window kernel value(s) for rate in [-1, 1] (reference libcsdr.c:76-97)."""
    rate = np.asarray(rate, dtype=np.float64)
    w = window.upper()
    if w == BLACKMAN:
        r = 0.5 + rate / 2
        return 0.42 - 0.5 * np.cos(2 * np.pi * r) + 0.08 * np.cos(4 * np.pi * r)
    if w == HAMMING:
        r = 0.5 + rate / 2
        return 0.54 - 0.46 * np.cos(2 * np.pi * r)
    if w == BOXCAR:
        return np.ones_like(rate)
    return window_kernel(WINDOW_DEFAULT, rate)


def normalize_fir(taps: np.ndarray) -> np.ndarray:
    """Normalize to unit DC gain (reference libcsdr.c:119-126)."""
    return taps / np.sum(taps)


def firdes_filter_len(transition_bw: float) -> int:
    """taps = int(4/transition_bw), forced odd (reference libcsdr.c:169-174).

    The C parameter is a FLOAT: 4.0/0.05f = 79.9999988 truncates to 79
    (not 80->81) because float32(0.05) > 0.05.  Reproducing that promotion
    is what makes `csdr fir_decimate_cc 4 0.05` and this CLI compute the
    same taps_length (caught by tests/test_binary_parity.py)."""
    result = int(4.0 / np.float64(np.float32(transition_bw)))
    if result % 2 == 0:
        result += 1
    return result


def firdes_lowpass_f(length: int, cutoff_rate: float, window: str = WINDOW_DEFAULT) -> np.ndarray:
    """Symmetric windowed-sinc lowpass, normalized (reference libcsdr.c:127-142).

    length should be odd; cutoff_rate = cutoff_freq / sample_rate.
    """
    middle = length // 2
    i = np.arange(1, middle + 1, dtype=np.float64)
    taps = np.empty(length, dtype=np.float64)
    taps[middle] = 2 * np.pi * cutoff_rate * window_kernel(window, 0.0)
    side = (np.sin(2 * np.pi * cutoff_rate * i) / i) * window_kernel(window, i / middle)
    taps[middle + 1:] = side
    taps[middle - 1::-1] = side
    return normalize_fir(taps).astype(np.float32)


def firdes_bandpass_c(length: int, lowcut: float, highcut: float,
                      window: str = WINDOW_DEFAULT) -> np.ndarray:
    """Complex bandpass: lowpass spectrally shifted by e^{jw}
    (reference libcsdr.c:144-167).  Returns complex64 taps."""
    real = firdes_lowpass_f(length, (highcut - lowcut) / 2, window).astype(np.float64)
    center = (highcut + lowcut) / 2
    # The reference accumulates phase with wrap-to-[0,2pi) each step; plain
    # n*w differs only at the 1e-7 level over typical lengths.
    phase = (np.arange(length, dtype=np.float64) * (2 * np.pi * center)) % (2 * np.pi)
    taps = real * np.exp(1j * phase)
    return taps.astype(np.complex64)


def rational_resampler_get_lowpass_f(length: int, interpolation: int, decimation: int,
                                     window: str = WINDOW_DEFAULT) -> np.ndarray:
    """Anti-alias lowpass for I/D resampling (reference libcsdr.c:664-673)."""
    cutoff = min(1.0 / interpolation, 1.0 / decimation)
    return firdes_lowpass_f(length, cutoff / 2, window)


def firdes_add_peak_c(length: int, rates, window: str = WINDOW_DEFAULT,
                      normalize: bool = True) -> np.ndarray:
    """Multi-peak complex filter: sum of NCO-windowed tap sets, then L1-ish
    normalize by sum of magnitudes (reference libcsdr.c:2232-2272).

    ``rates`` is a scalar or sequence of peak frequencies (rate units).
    """
    rates = np.atleast_1d(np.asarray(rates, dtype=np.float64))
    middle = length // 2
    i = np.arange(length, dtype=np.float64)
    wmult = window_kernel(window, np.abs((middle - i) / middle))
    out = np.zeros(length, dtype=np.complex128)
    for rate in rates:
        phase = (i * (-rate * 2 * np.pi)) % (2 * np.pi)
        out += np.exp(1j * phase) * wmult
    if normalize:
        out /= np.sum(np.abs(out))
    return out.astype(np.complex64)


def firdes_rrc_f(taps_length: int, samples_per_symbol: int, beta: float) -> np.ndarray:
    """Root-raised-cosine matched filter (reference libcsdr.c:2482-2497)."""
    middle = taps_length // 2
    taps = np.empty(taps_length, dtype=np.float64)
    sps = float(samples_per_symbol)
    taps[middle] = (1 / sps) * (1 + beta * (4 / np.pi - 1))
    for i in range(1, middle + 1):
        if i == samples_per_symbol / (4 * beta):
            v = (beta / (sps * np.sqrt(2))) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            t = i / sps
            v = (1 / sps) * (
                np.sin(np.pi * t * (1 - beta)) + 4 * beta * t * np.cos(np.pi * t * (1 + beta))
            ) / (np.pi * t * (1 - (4 * beta * t) ** 2))
        taps[middle + i] = taps[middle - i] = v
    return normalize_fir(taps).astype(np.float32)


def firdes_cosine_f(taps_length: int, samples_per_symbol: int) -> np.ndarray:
    """Cosine matched filter for PSK31 (reference libcsdr.c:2473-2480).

    Needs taps_length >= 2*samples_per_symbol + 1; outer taps are zero.
    """
    middle = taps_length // 2
    taps = np.zeros(taps_length, dtype=np.float64)
    i = np.arange(samples_per_symbol, dtype=np.float64)
    v = (1 + np.cos(np.pi * i / samples_per_symbol)) / 2
    taps[middle: middle + samples_per_symbol] = v
    taps[middle - samples_per_symbol + 1: middle + 1] = v[::-1]
    return normalize_fir(taps).astype(np.float32)


def precalculate_window(size: int, window: str = WINDOW_DEFAULT) -> np.ndarray:
    """Per-bin window for FFT framing (reference libcsdr.c:1256-1276):
    window_function(2*i/(size-1) + 1) — note the reference's argument wraps
    past +1, making the window periodic-ish; reproduced exactly."""
    i = np.arange(size, dtype=np.float64)
    rate = i / (size - 1)
    return window_kernel(window, 2.0 * rate + 1.0).astype(np.float32)


def deemphasis_nfm_taps(sample_rate: int) -> np.ndarray:
    """NFM de-emphasis FIR (reference predefined.h:41-68).

    48000/44100/11025 sps use the reference's own precomputed arrays
    verbatim (ops/_nfm_deemph_tables.py).  The reference's 8000 sps array
    is numerically broken (values ~1e14), so that one is regenerated from
    the recipe the reference documents (predefined.h:44-55):
        firls(tapnum, [0,200, 200,400, 400,3700, 3700,sr/2]/(sr/2),
              [0,0, 0,1, 1,0.1, 0,0])
        then normalize gain to 0 dB at 500 Hz by projecting onto a sine.
    Documented deviation: at 8000 sps outputs intentionally differ from
    the reference binary (which would emit ~1e14-scaled garbage).
    """
    from csdr_tpu_torch.ops import _nfm_deemph_tables as t

    table = {48000: t.DEEMPHASIS_NFM_FIR_48000,
             44100: t.DEEMPHASIS_NFM_FIR_44100,
             11025: t.DEEMPHASIS_NFM_FIR_11025}.get(sample_rate)
    if table is not None:
        return np.asarray(table, np.float32)
    if sample_rate != 8000:
        raise ValueError(
            f"no NFM de-emphasis taps for sample_rate={sample_rate}")

    from scipy.signal import firls

    ntaps = 79
    nyq = sample_rate / 2.0
    hi = min(3700.0, nyq * 0.95)
    bands = [0, 200, 200, 400, 400, hi, hi, nyq]
    desired = [0, 0, 0, 1, 1, 0.1, 0, 0]
    taps = firls(ntaps, bands, desired, fs=sample_rate)
    norm_freq = 500.0
    i = np.arange(ntaps, dtype=np.float64)
    gain = float(np.dot(taps, np.sin(2 * np.pi * norm_freq * i
                                     / sample_rate)))
    taps = taps / gain
    return taps.astype(np.float32)
