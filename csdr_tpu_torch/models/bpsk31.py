"""BPSK31 TX/RX chains and BER harness (counterpart of
csdr_tpu.models.bpsk31), the reference's end-to-end acceptance test
(grc_tests/bpsk31_ber.py:16-26):

TX: psk31_varicode_encoder | differential_encoder | psk_modulator_u8_c 2
    | psk31_interpolate_sine_cc 256 | awgn_cc <snr>
RX: timing_recovery_cc GARDNER 256 0.5 2 --add_q | dbpsk_decoder_c_u8
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core import cplx
from csdr_tpu_torch.core.block import resolve_device
from csdr_tpu_torch.ops import digital, noise as noise_ops, sync

MESSAGE = b"CQ CQ CQ DE HA7ILM HA7ILM HA7ILM PSE K "


def tx_chain(text: bytes, interpolation: int = 256, device="cuda"):
    """Text -> (bit stream u8 numpy, baseband complex64 on ``device``)."""
    dev = resolve_device(device)
    bits = digital.psk31_varicode_encoder_u8_u8(np.frombuffer(text, np.uint8))
    enc, _ = digital.differential_codec_encode(torch.from_numpy(bits).to(dev))
    symbols = digital.psk_modulator_u8_c(enc, 2)
    bb, _ = digital.psk31_interpolate_sine_cc(symbols, interpolation)
    return bits, bb


def rx_chain(x, interpolation: int = 256, chunk: int | None = None,
             device="cuda") -> np.ndarray:
    """Baseband (numpy or tensor) -> recovered bit stream (u8 numpy), the
    timing recovery streamed over chunks of ``chunk`` samples."""
    dev = resolve_device(device)
    x = x.to(dev) if isinstance(x, torch.Tensor) else cplx.from_numpy(x, dev)
    blk = sync.timing_recovery_block("GARDNER", interpolation, loop_gain=0.5,
                                     max_error=2.0, use_q=True)
    st = blk.init(dev)
    n = x.shape[0]
    chunk = chunk or n
    syms = []
    with torch.no_grad():
        for c in range(n // chunk):
            st, out = blk(st, x[c * chunk:(c + 1) * chunk])
            syms.append(out.compact())
        bits, _ = digital.dbpsk_decoder_c_u8(torch.cat(syms))
    return cplx.to_numpy(bits)


def align_errors(bits_in: np.ndarray, bits_out: np.ndarray,
                 shifts=range(-5, 5)):
    """(errors, compared bits) at the best alignment of the two streams,
    the reference harness's search (bpsk31_ber.py:35-42)."""
    best = None
    for shift in shifts:
        a, b = bits_in, bits_out
        if shift < 0:
            a = np.concatenate([np.zeros(-shift, np.uint8), a])
        elif shift > 0:
            b = np.concatenate([np.zeros(shift, np.uint8), b])
        m = min(len(a), len(b))
        errs = int(np.sum(a[:m] != b[:m]))
        if best is None or errs < best[0]:
            best = (errs, m)
    return best


def ber_at_snr(snr_db: float, nchars: int = 400, seed: int = 0,
               message: bytes = MESSAGE, device="cuda") -> tuple[float, int]:
    """One point of the reference BER curve (bpsk31_ber.py:45-53):
    generate, add AWGN at ``snr_db``, receive, compare bits at the best of
    +-5 alignments.  Returns (ber, total_bits)."""
    text = (message * (nchars // len(message) + 1))[:nchars]
    bits_in, bb = tx_chain(text, device=device)
    bits_out = rx_chain(noise_ops.awgn_cc(bb, snr_db, seed=seed),
                        device=device)
    errs, total = align_errors(bits_in, bits_out)
    return errs / total, total


def ber_curve(snrs=range(0, 20, 2), nchars: int = 400, seed: int = 0,
              device="cuda"):
    """The full `snr; errors; totalbits; BER` sweep of bpsk31_ber.py."""
    rows = []
    for snr in snrs:
        ber, total = ber_at_snr(snr, nchars, seed, device=device)
        rows.append((snr, int(round(ber * total)), total, ber))
    return rows
