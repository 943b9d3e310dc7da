"""FFT-domain FIR filtering: bandpass_fir_fft_cc by overlap-add
(counterpart of csdr_tpu.ops.fftfilt; reference csdr.c:1810-1886 and
libcsdr.c:814-849 apply_fir_fft_cc).

Sizing is the reference's: fft_size = next_pow2(taps_length), doubled if
the zero-pad headroom is < 200; input_size = fft_size - T + 1; overlap =
T - 1.  B frames per chunk go through ONE batched forward FFT and ONE
inverse: K3's pair (``kernels/fft_cuda``) with the taps spectrum stored in
its bin order, so the product happens in kernel order and nothing
reorders.  The overlap-add is the reference's accumulate-then-split as
J+1 shifted adds (J = ceil(fft/input) - 1), right even when the overlap
exceeds input_size.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch import firdes
from csdr_tpu_torch.core import fft as cfft
from csdr_tpu_torch.core.block import Block, resolve_device
from csdr_tpu_torch.kernels import fft_cuda


def fftfilt_plan(taps_length: int):
    fft_size = cfft.next_pow2(taps_length)
    if fft_size - taps_length < 200:
        fft_size <<= 1
    input_size = fft_size - taps_length + 1
    overlap = taps_length - 1
    return fft_size, input_size, overlap


def _taps_fft(taps: np.ndarray, fft_size: int) -> np.ndarray:
    padded = np.zeros(fft_size, np.complex128)
    padded[: len(taps)] = taps
    return np.fft.fft(padded).astype(np.complex64)


def apply_fir_fft_cc_batch(x: torch.Tensor, taps_fft: torch.Tensor,
                           input_size: int, carry: torch.Tensor,
                           taps_fft_ko: torch.Tensor | None = None):
    """x: (B, fft_size) zero-padded frames; returns (y (B, input_size),
    new_carry (overlap,)), libcsdr.c:814-849 with its 1/fft_size scaling.
    With ``taps_fft_ko`` (the taps spectrum in kernel bin order) and a frame
    size K3 takes, the round trip is fft_ko -> product -> ifft_ko."""
    fft_size = x.shape[-1]
    overlap = fft_size - input_size
    if taps_fft_ko is not None and fft_cuda.supported(fft_size, x.shape[0]):
        y = fft_cuda.ifft_ko(fft_cuda.fft_ko(x) * taps_fft_ko) \
            * (1.0 / fft_size)
    else:
        y = cfft.ifft(cfft.fft(x) * taps_fft, normalize=True)
    # every frame's FULL fft_size result accumulates at offset
    # b*input_size (the C adds the carry into the whole result buffer
    # before splitting emit/tail, libcsdr.c:844-849)
    b = x.shape[0]
    jmax = -(-fft_size // input_size) - 1          # frames a tail can span
    pad_cols = (jmax + 1) * input_size - fft_size
    zp = torch.cat([y, y.new_zeros(b, pad_cols)], 1)
    out = y.new_zeros((b + jmax) * input_size)
    for j in range(jmax + 1):
        out[j * input_size: (j + b) * input_size] += \
            zp[:, j * input_size: (j + 1) * input_size].reshape(-1)
    out[:overlap] += carry
    emit = out[: b * input_size].reshape(b, input_size)
    return emit, out[b * input_size: b * input_size + overlap].clone()


def bandpass_taps_spectra(transition_bw: float, low_cut: float,
                          high_cut: float,
                          window: str = firdes.WINDOW_DEFAULT):
    """Taps spectra for one band: (taps_fft (fft,) complex64, taps_fft_ko
    in K3's bin order, H_ko[perm] = H_nat, or None when K3 does not take
    the frame size), on the CPU."""
    taps_length = firdes.firdes_filter_len(transition_bw)
    fft_size, _input_size, _overlap = fftfilt_plan(taps_length)
    taps = firdes.firdes_bandpass_c(taps_length, low_cut, high_cut, window)
    tf = _taps_fft(taps, fft_size)
    taps_fft_ko = None
    if fft_cuda.supported(fft_size, 1):
        tko = np.empty_like(tf)
        tko[fft_cuda.kernel_perm(fft_size)] = tf
        taps_fft_ko = torch.from_numpy(tko)
    return torch.from_numpy(tf), taps_fft_ko


class BandpassFirFftBlock(Block):
    """Streaming overlap-add complex bandpass.  Chunks are a multiple of
    input_size; output length == input length.  The taps spectra are
    buffers; the state is the overlap carry."""

    def __init__(self, low_cut: float, high_cut: float, transition_bw: float,
                 window: str = firdes.WINDOW_DEFAULT,
                 name: str = "bandpass_fir_fft_cc"):
        super().__init__(name)
        taps_length = firdes.firdes_filter_len(transition_bw)
        self.fft_size, self.input_size, self.overlap = \
            fftfilt_plan(taps_length)
        taps_fft, taps_fft_ko = bandpass_taps_spectra(
            transition_bw, low_cut, high_cut, window)
        self.register_buffer("taps_fft", taps_fft)
        self.register_buffer("taps_fft_ko", taps_fft_ko)

    def init(self, device="cuda"):
        return torch.zeros(self.overlap, dtype=torch.complex64,
                           device=resolve_device(device))

    def forward(self, carry, x):
        ins = self.input_size
        if x.shape[0] % ins:
            raise ValueError(f"chunk of {x.shape[0]} samples is not a "
                             f"multiple of input_size {ins}")
        b = x.shape[0] // ins
        frames = torch.cat([x.reshape(b, ins),
                            x.new_zeros(b, self.fft_size - ins)], 1)
        y, carry = apply_fir_fft_cc_batch(frames, self.taps_fft, ins, carry,
                                          taps_fft_ko=self.taps_fft_ko)
        return carry, y.reshape(-1)

    def state_from_jax(self, leaves):
        carry = leaves.complex((self.overlap,), f"{self.name} carry")
        leaves.matches(self.taps_fft, f"{self.name} taps spectrum")
        if self.taps_fft_ko is not None:
            leaves.matches(self.taps_fft_ko,
                           f"{self.name} kernel-order taps spectrum")
        return carry


def bandpass_fir_fft_block(low_cut: float, high_cut: float,
                           transition_bw: float,
                           window: str = firdes.WINDOW_DEFAULT,
                           name: str = "bandpass_fir_fft_cc") -> Block:
    return BandpassFirFftBlock(low_cut, high_cut, transition_bw, window, name)
