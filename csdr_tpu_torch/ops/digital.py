"""Digital modem blocks: PSK31 varicode, RTTY baudot, slicers, PSK
modulator, differential coding, DBPSK, bit (de)serialization
(counterpart of csdr_tpu.ops.digital).  The byte-domain ops give
csdr_tpu's bytes bit for bit.

As in csdr_tpu, the varicode encoder, the serial line decoder and the
pattern search are host-side numpy (stream sources and sinks at symbol
rates); everything else is torch on the input's device.  The elementwise
ops, ``psk31_interpolate_sine_cc``, ``dbpsk_decoder_c_u8`` and the RTTY
decoder take leading batch axes (one row per channel); the varicode
decoder and ``rtty_baudot2ascii_u8_u8`` take one stream, as csdr_tpu's.
The RTTY decoder's start/stop machine, csdr_tpu's ``lax.scan``, is one
launch of a hand-written kernel a call on the card (``kernels/
baudot_cuda``, ``csrc/baudot.cu``), its plain loop on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from csdr_tpu_torch.core.block import VarOut
from csdr_tpu_torch.core.cplx import expj
from csdr_tpu_torch.kernels import baudot_cuda
from csdr_tpu_torch.kernels.baudot_cuda import compact as _compact
from csdr_tpu_torch.ops._varicode_table import VARICODE
from csdr_tpu_torch.ops.fir import apply_fir_cc


# --------------------------------------------------------------------------
# PSK31 varicode
# --------------------------------------------------------------------------

def psk31_varicode_encoder_u8_u8(text: np.ndarray) -> np.ndarray:
    """ASCII bytes -> bit stream (one u8 per bit), each character's code
    followed by two 0 separator bits (reference libcsdr.c:1489-1514).
    Host-side numpy (source-side codec at symbol rate)."""
    out = []
    for ch in np.asarray(text, np.uint8):
        code, bits = VARICODE[int(ch)]
        for bi in range(bits):
            out.append((code >> (bits - bi - 1)) & 1)
        out.extend((0, 0))
    return np.asarray(out, np.uint8)


def _varicode_decode_tables():
    """Codes grouped by window length L = bitcount + 4, each with its
    expected window value 00<code>00 (libcsdr.c:1480-1485)."""
    groups: dict[int, list] = {}
    for ascii_val, (code, bits) in enumerate(VARICODE):
        groups.setdefault(bits + 4, []).append((code << 2, ascii_val))
    return groups


_VC_GROUPS = _varicode_decode_tables()


def psk31_varicode_decoder_u8_u8(bits: torch.Tensor, max_out: int | None = None,
                                 skip: int = 0) -> VarOut:
    """Bit stream (n,) -> VarOut of ASCII bytes, by a sliding-window match:
    a character is emitted at bit n when the last (bitcount+4) bits equal
    00<code>00.  ``skip`` suppresses matches ending before bit ``skip``
    (history a streaming caller prepends).  The count is a device tensor."""
    bits = bits.to(torch.int32) & 1
    n = bits.shape[0]
    cap = max_out or n // 6 + 8
    ascii_hit = torch.zeros(n, dtype=torch.int32, device=bits.device)
    hit = torch.zeros(n, dtype=torch.bool, device=bits.device)
    for length, codes in _VC_GROUPS.items():
        # rolling window value ending at each bit, MSB = oldest
        pw = 2 ** torch.arange(length - 1, -1, -1, dtype=torch.int32,
                               device=bits.device)
        padded = torch.cat([bits.new_ones(length - 1), bits])
        win = (padded.unfold(0, length, 1) * pw).sum(1, dtype=torch.int32)
        for value, ascii_val in codes:
            m = win == value
            hit = hit | m
            ascii_hit = torch.where(m, ascii_val, ascii_hit)
    if skip:
        hit = hit & (torch.arange(n, device=bits.device) >= skip)
    data, count = _compact(hit, ascii_hit, cap)
    return VarOut(data.to(torch.uint8), count)


# --------------------------------------------------------------------------
# RTTY baudot (reference libcsdr.c:1576-1654)
# --------------------------------------------------------------------------

# 5-bit code -> (letters, figures); codes not present map to 0: the public
# ITA2/US-TTY alphabet (also reference libcsdr.c:1576-1608)
_BAUDOT_PAIRS = {
    0b00000: (0, 0), 0b10000: ("E", "3"), 0b01000: ("\n", "\n"),
    0b11000: ("A", "-"), 0b00100: (" ", " "), 0b10100: ("S", "'"),
    0b01100: ("I", "8"), 0b11100: ("U", "7"), 0b00010: ("\r", "\r"),
    0b10010: ("D", "#"), 0b01010: ("R", "4"), 0b11010: ("J", "\a"),
    0b00110: ("N", ","), 0b10110: ("F", "@"), 0b01110: ("C", ":"),
    0b11110: ("K", "("), 0b00001: ("T", "5"), 0b10001: ("Z", "+"),
    0b01001: ("L", ")"), 0b11001: ("W", "2"), 0b00101: ("H", "$"),
    0b10101: ("Y", "6"), 0b01101: ("P", "0"), 0b11101: ("Q", "1"),
    0b00011: ("O", "9"), 0b10011: ("B", "?"), 0b01011: ("G", "*"),
    0b00111: ("M", "."), 0b10111: ("X", "/"), 0b01111: ("V", "="),
}
RTTY_FIGURE_MODE_SELECT_CODE = baudot_cuda.FIGURE_SELECT
RTTY_LETTER_MODE_SELECT_CODE = baudot_cuda.LETTER_SELECT

_BAUDOT_LETTERS = np.zeros(32, np.int32)
_BAUDOT_FIGURES = np.zeros(32, np.int32)
for _code, (_l, _f) in _BAUDOT_PAIRS.items():
    _BAUDOT_LETTERS[_code] = ord(_l) if isinstance(_l, str) else _l
    _BAUDOT_FIGURES[_code] = ord(_f) if isinstance(_f, str) else _f


@functools.cache
def _baudot_tables(device) -> tuple:
    """The letters and figures tables on ``device``, uploaded once, so a
    captured step reads them from the card."""
    return (torch.from_numpy(_BAUDOT_LETTERS).to(device),
            torch.from_numpy(_BAUDOT_FIGURES).to(device))


def rtty_baudot_decoder(symbols: torch.Tensor, max_out: int | None = None,
                        state=None):
    """Bit symbols (..., n) -> VarOut of ASCII, through the reference's
    start/stop-pulse state machine (libcsdr.c:1622-1654), one launch of
    the Baudot kernel on the card (``kernels/baudot_cuda``, csdr_tpu's
    lax.scan), the plain loop on the CPU.

    state = (machine_state, fig_mode, shr, bit_cntr, char_received), int32
    tensors shaped like ``symbols`` without its last axis (None: the
    stream's start, ``kernels/baudot_cuda.zero_state``); returns (VarOut,
    state'), the count on the symbols' device."""
    n = symbols.shape[-1]
    dev = symbols.device
    cap = max_out or n // 7 + 4
    if state is None:
        state = baudot_cuda.zero_state(symbols.shape[:-1], dev)
    if n == 0:
        empty = torch.zeros(symbols.shape[:-1] + (cap,), dtype=torch.uint8,
                            device=dev)
        state = tuple(t.to(torch.int32) for t in state)
        return VarOut(empty, torch.zeros_like(state[0])), state
    data, count, state = baudot_cuda.decode(symbols, cap, state,
                                            *_baudot_tables(dev))
    return VarOut(data, count), state


def rtty_baudot2ascii_u8_u8(codes: torch.Tensor, fig_mode=0):
    """Direct 5-bit baudot codes (n,) -> ASCII (reference
    rtty_baudot_decoder_lookup, libcsdr.c:1613-1621), the figures/letters
    mode a carried prefix state: a cummax over the indices of mode-select
    codes gives each position its governing select code.

    Returns (VarOut ascii, fig_mode')."""
    c = codes.to(torch.int64) & 31
    n = c.shape[0]
    dev = c.device
    fig_mode = torch.as_tensor(fig_mode, dtype=torch.int32, device=dev)
    is_fig = c == RTTY_FIGURE_MODE_SELECT_CODE
    is_ltr = c == RTTY_LETTER_MODE_SELECT_CODE
    sel = is_fig | is_ltr
    idx = torch.where(sel, torch.arange(n, device=dev), -1)
    last_sel = torch.cummax(idx, 0).values if n else idx
    mode = torch.where(last_sel >= 0,
                       is_fig.to(torch.int32)[torch.clamp(last_sel, min=0)],
                       fig_mode)
    letters, figures = _baudot_tables(dev)
    ch = torch.where(mode != 0, figures[c], letters[c])
    emit = ~sel & (ch != 0)
    data, count = _compact(emit, ch, n)
    new_mode = mode[-1] if n > 0 else fig_mode
    return VarOut(data.to(torch.uint8), count), new_mode


# --------------------------------------------------------------------------
# slicers / modulators / bit plumbing
# --------------------------------------------------------------------------

def binary_slicer_f_u8(x: torch.Tensor) -> torch.Tensor:
    """x > 0 -> 1 (reference libcsdr.c:1768-1770)."""
    return (x > 0).to(torch.uint8)


def generic_slicer_f_u8(x: torch.Tensor, n_symbols: int) -> torch.Tensor:
    """N-level slicer over [-1, 1] (reference libcsdr.c:1731-1766)."""
    dist = 2.0 / (n_symbols - 1)
    j = torch.round((x + 1.0) / dist).to(torch.int32)
    return torch.clamp(j, 0, n_symbols - 1).to(torch.uint8)


def psk_modulator_u8_c(symbols: torch.Tensor, n_psk: int) -> torch.Tensor:
    """symbol k -> e^{j*2*pi*k/N} (reference libcsdr.c:1772-1782)."""
    return expj((2 * np.pi / n_psk) * symbols.to(torch.float32))


def duplicate_samples_ntimes_u8_u8(x: torch.Tensor, sample_size_bytes: int,
                                   ntimes: int) -> torch.Tensor:
    """reference libcsdr.c:1784-1791"""
    g = x.reshape(-1, sample_size_bytes)
    return torch.repeat_interleave(g, ntimes, dim=0).reshape(-1)


@functools.cache
def _interp_rates(interpolation: int, device) -> torch.Tensor:
    """rate_j of :func:`psk31_interpolate_sine_cc` on ``device``, uploaded
    once, so a captured step reads them from the card."""
    j = np.arange(interpolation, dtype=np.float64)
    return torch.from_numpy(((1 + np.sin(-np.pi / 2 + np.pi * (j + 1)
                                         / interpolation)) / 2
                             ).astype(np.float32)).to(device)


def psk31_interpolate_sine_cc(x: torch.Tensor, interpolation: int,
                              last_input: torch.Tensor | None = None):
    """Cosine-envelope symbol interpolation (reference libcsdr.c:1793-1808):
    output[i*I+j] = x[i]*rate_j + x[i-1]*(1-rate_j),
    rate_j = (1+sin(-pi/2 + pi*(j+1)/I))/2.  ``x`` is (..., n) complex64;
    returns (y (..., n*I), new_last)."""
    if last_input is None:
        last_input = x.new_zeros(x.shape[:-1])
    rate = _interp_rates(interpolation, x.device)
    prev = torch.cat([last_input[..., None], x[..., :-1]], -1)
    parts = []
    for cur, old in ((x.real, prev.real), (x.imag, prev.imag)):
        parts.append(cur[..., None] * rate + old[..., None] * (1 - rate))
    y = torch.complex(*parts)
    return y.reshape(x.shape[:-1] + (-1,)), x[..., -1]


def pack_bits_1to8_u8_u8(x: torch.Tensor) -> torch.Tensor:
    """Each byte -> 8 bit-bytes, LSB first (reference libcsdr.c:1810-1815)."""
    k = torch.arange(8, dtype=torch.uint8, device=x.device)
    return ((x.to(torch.uint8)[:, None] >> k) & 1).reshape(-1)


def pack_bits_8to1_u8_u8(bits: torch.Tensor) -> torch.Tensor:
    """8 bit-bytes -> 1 byte, first bit = MSB (reference libcsdr.c:1818-1827)."""
    g = (bits != 0).to(torch.int32).reshape(-1, 8)
    w = 2 ** torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (g * w).sum(1).to(torch.uint8)


def invert_u8_u8(x: torch.Tensor) -> torch.Tensor:
    return (1 - (x.to(torch.int32) & 1)).to(torch.uint8)


def differential_codec_encode(x: torch.Tensor, state=0):
    """Encode: the state toggles on 0-bits (reference libcsdr.c:1834-1841),
    out[n] = state0 XOR parity(zeros up to n).  Returns (out, out[-1])."""
    x = (x != 0).to(torch.int32)
    flips = torch.cumsum(1 - x, -1, dtype=torch.int32) & 1
    state = torch.as_tensor(state, dtype=torch.int32, device=x.device)
    out = (state[..., None] ^ flips) & 1
    return out.to(torch.uint8), out[..., -1]


def differential_codec_decode(x: torch.Tensor, state=0):
    """Decode: out[n] = (x[n] == x[n-1]) with x[-1] = state (reference
    libcsdr.c:1828-1833).  Returns (out, new_state = x[-1])."""
    x = (x != 0).to(torch.int32)
    first = torch.as_tensor(state, dtype=torch.int32,
                            device=x.device).expand(x.shape[:-1] + (1,))
    prev = torch.cat([first, x[..., :-1]], -1)
    return (x == prev).to(torch.uint8), x[..., -1]


def dbpsk_decoder_c_u8(x: torch.Tensor, last_input: torch.Tensor | None = None,
                       count=None):
    """|dphase| > pi/2 -> 0 else 1 (reference libcsdr.c:2319-2333) on
    complex64 symbols (..., n).  Returns (bits u8, new_last).

    count: for a VarOut-padded stream (a valid prefix of ``count`` symbols
    a row, a tensor shaped like ``x`` without its last axis), new_last is
    the last VALID symbol instead of a pad zero, which would corrupt the
    first bit of the next chunk; a row with no valid symbol keeps its
    ``last_input``.  None keeps the whole-array contract."""
    if last_input is None:
        last_input = x.new_zeros(x.shape[:-1])
    phase = torch.atan2(x.imag, x.real)
    prev_phase = torch.cat([torch.atan2(last_input.imag, last_input.real
                                        )[..., None], phase[..., :-1]], -1)
    d = phase - prev_phase
    d = torch.where(d < -np.pi, d + 2 * np.pi, d)
    d = torch.where(d >= np.pi, d - 2 * np.pi, d)
    bits = ((d <= np.pi / 2) & (d >= -np.pi / 2)).to(torch.uint8)
    if count is None:
        return bits, x[..., -1]
    count = torch.as_tensor(count, device=x.device)
    at = torch.clamp(count - 1, min=0).to(torch.int64)[..., None]
    lv = torch.gather(x, -1, at)[..., 0]
    return bits, torch.where(count > 0, lv, last_input)


def bfsk_demod_cf(x: torch.Tensor, mark_filter, space_filter) -> torch.Tensor:
    """|mark FIR|^2 - |space FIR|^2, valid mode (reference
    libcsdr.c:2335-2351), on ``ops/fir.apply_fir_cc``."""
    m = apply_fir_cc(x, mark_filter)
    s = apply_fir_cc(x, space_filter)
    return (m.real * m.real + m.imag * m.imag) \
        - (s.real * s.real + s.imag * s.imag)


def normalized_timing_variance_u32_f(indexes: torch.Tensor,
                                     samples_per_symbol: int,
                                     initial_sample_offset: int):
    """TED quality metric (reference libcsdr.c:2293-2317): variance of the
    sampled indexes' deviation from the ideal comb, in radians^2."""
    inp = indexes.to(torch.int32)
    rel = inp - initial_sample_offset
    nearest = torch.div(rel, samples_per_symbol, rounding_mode="floor")
    rem = torch.remainder(rel, samples_per_symbol)
    nearest = torch.where(rem > samples_per_symbol // 2, nearest + 1, nearest)
    correct = initial_sample_offset + nearest * samples_per_symbol
    ndiff = torch.abs(correct - inp).to(torch.float32) / samples_per_symbol
    nrad = ndiff * np.pi
    mean = torch.mean(nrad)
    return torch.sum((nrad - mean) ** 2) / (inp.shape[0] - 1)


# --------------------------------------------------------------------------
# software UART and pattern search (host-side numpy, stream sinks)
# --------------------------------------------------------------------------

def serial_line_decoder_f_u8(x: np.ndarray, samples_per_bits: float,
                             databits: int = 8, stopbits: float = 1.0,
                             bit_sampling_width_ratio: float = 0.4):
    """Software UART (reference libcsdr.c:1656-1729): edge-find the start
    bit, integrate bit windows, verify the stop bit.  Host numpy (the rates
    are bytes/sec; this is a stream sink).  Returns (bytes, input_used)."""
    x = np.asarray(x, np.float32)
    out = []
    used = 0
    n = len(x)
    base = 0
    all_bits = 1 + databits + stopbits
    r = bit_sampling_width_ratio
    while True:
        seg = x[base:]
        if len(seg) < 2:
            used = n
            break
        edges = np.nonzero((seg[1:] < 0) & (seg[:-1] > 0))[0] + 1
        if len(edges) == 0:
            used = n
            break
        s = int(edges[0])
        if base + s + samples_per_bits * all_bits >= n:
            used = base + max(0, s - 2)
            break
        shr = 0
        for di in range(databits):
            b0 = base + s + int((1 + di + 0.5 * (1 - r)) * samples_per_bits)
            b1 = base + s + int((1 + di + 0.5 * (1 + r)) * samples_per_bits)
            shr = (shr << 1) | (1 if x[b0:b1].sum() > 0 else 0)
        sb0 = base + s + int((1 + databits) * samples_per_bits
                             + stopbits * 0.5 * (1 - r) * samples_per_bits)
        sb1 = base + s + int((1 + databits) * samples_per_bits
                             + stopbits * 0.5 * (1 + r) * samples_per_bits)
        if x[sb0:sb1].sum() < 0:
            base = min(base + s + 1, n)
            used = base
            continue
        out.append(shr)
        base = min(base + s + int(all_bits * samples_per_bits), n)
        used = base
        if base >= n:
            break
    return np.asarray(out, np.uint32), used


def pattern_search_u8_u8(x: np.ndarray, pattern: np.ndarray,
                         values_after: int) -> np.ndarray:
    """Every occurrence of ``pattern`` in the byte stream, and the
    ``values_after`` bytes that follow each (reference csdr.c:3532-3597;
    deframes sync-word protocols).  Host-side (byte sink)."""
    x = np.asarray(x, np.uint8)
    p = np.asarray(pattern, np.uint8)
    lp = len(p)
    if len(x) < lp:
        return np.zeros((0, values_after), np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(x, lp)
    hits = np.nonzero((windows == p).all(axis=1))[0]
    out = [x[h + lp: h + lp + values_after] for h in hits]
    out = [seg for seg in out if len(seg) == values_after]
    return np.stack(out) if out else np.zeros((0, values_after), np.uint8)
