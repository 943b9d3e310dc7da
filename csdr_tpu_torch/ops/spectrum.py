"""Spectrum / waterfall path (counterpart of csdr_tpu.ops.spectrum):
windowed FFT framing, power logs, frame averaging, side exchange, and the
glue to the ADPCM row compression.

The waterfall chain every csdr/OpenWebRX receiver runs beside its
demodulator is
    fft_cc | logaveragepower_cf | fft_exchange_sides_ff
    | compress_fft_adpcm_f_u8
and here a chunk of it is one batched FFT of all its frames (K3 on the
card where it takes N) and one codec launch for all its rows.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch import firdes
from csdr_tpu_torch.core import fft as cfft
from csdr_tpu_torch.core.block import Block, resolve_device
from csdr_tpu_torch.kernels import fft_cuda
from csdr_tpu_torch.ops import adpcm


def _abs2(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 as csdr_tpu's CF.abs2: re*re + im*im."""
    return x.real * x.real + x.imag * x.imag


def logpower_cf(x: torch.Tensor, add_db: float = 0.0) -> torch.Tensor:
    """10*log10(|x|^2) + add_db (reference libcsdr.c:1296-1302)."""
    return (10.0 * torch.log10(_abs2(x)) + add_db).to(torch.float32)


def accumulate_power_cf(x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """acc + |x|^2 (reference libcsdr.c:1304-1307)."""
    return acc + _abs2(x)


def log_ff(x: torch.Tensor, add_db: float = 0.0) -> torch.Tensor:
    return (10.0 * torch.log10(x) + add_db).to(torch.float32)


def total_logpower_cf(x: torch.Tensor) -> torch.Tensor:
    """10*log10(mean power) over ALL elements (reference
    libcsdr.c:1315-1321): a (B, fft) input divides by B*fft."""
    return 10.0 * torch.log10(torch.sum(_abs2(x)) / x.numel())


def fft_exchange_sides_ff(x: torch.Tensor) -> torch.Tensor:
    """Swap the halves of FFT rows (..., fft_size) (reference
    csdr.c:1697-1715)."""
    return torch.roll(x, x.shape[-1] // 2, dims=-1)


def fft_one_side_ff(x: torch.Tensor) -> torch.Tensor:
    """The positive half of FFT rows (reference csdr.c:1717-1734)."""
    return x[..., : x.shape[-1] // 2]


def _fft_batched(frames: torch.Tensor) -> torch.Tensor:
    """Natural-order FFT of (B, N) frames.  Routed by shape before any
    launch, as csdr_tpu routes it (``fft_pallas.use_kernel``): the sizes
    K3 takes (N a power of two in 128..16384) go to ``fft_natural`` (one
    launch of K3's natural-order forward on the card, ``torch.fft`` on
    the CPU); every
    other N, which csdr_tpu sends to its Stockham FFT, to ``torch.fft``."""
    if fft_cuda.supported(frames.shape[-1], frames.shape[0]):
        return fft_cuda.fft_natural(frames)
    return torch.fft.fft(frames)


class FftCcBlock(Block):
    """Windowed FFT of frames of ``fft_size`` samples, one every
    ``every_n_samples`` (reference csdr.c:1569-1644).  A chunk is a
    multiple of every_n_samples and gives (B, fft_size) complex64 spectra.

    - every_n >= fft_size: frame i is the first fft_size samples of stride
      i (the reference skips the rest); the state is empty.
    - every_n < fft_size: overlapped mode.  Frames end at the stride
      boundaries; the state is the last fft_size - every_n samples,
      zeros at the start.

    Frame i is ``[tail | chunk][i*every_n : i*every_n + fft_size]``, one
    strided view.  csdr_tpu cuts the same frames from shifted reshapes of
    a zero-padded array (``_frames_strided``); its padding lies past the
    last frame's end in both modes, so no frame sees it."""

    def __init__(self, fft_size: int, every_n_samples: int,
                 window: str = firdes.WINDOW_DEFAULT):
        super().__init__("fft_cc")
        if cfft.log2n(fft_size) == -1:
            raise ValueError("fft_size should be a power of 2")
        self.fft_size = fft_size
        self.every_n = every_n_samples
        self.overlap = max(fft_size - every_n_samples, 0)
        self.register_buffer("window", torch.from_numpy(
            firdes.precalculate_window(fft_size, window)))

    def init(self, device="cuda"):
        return torch.zeros((self.overlap,), dtype=torch.complex64,
                           device=resolve_device(device))

    def forward(self, tail, x):
        n = x.shape[0]
        if n % self.every_n:
            raise ValueError(f"fft_cc: a chunk of {n} samples is not a "
                             f"multiple of every_n_samples={self.every_n}")
        if self.overlap:
            x = torch.cat([tail, x])
            tail = x[n:].clone()
        frames = x.unfold(0, self.fft_size, self.every_n)
        windowed = torch.view_as_real(frames) * self.window[:, None]
        return tail, _fft_batched(torch.view_as_complex(windowed))


def fft_cc_block(fft_size: int, every_n_samples: int,
                 window: str = firdes.WINDOW_DEFAULT) -> Block:
    return FftCcBlock(fft_size, every_n_samples, window)


class FftFcBlock(Block):
    """Real-input variant (reference csdr.c:3414-3498): ``fft_out_size``
    output bins, each frame 2*fft_out_size real samples, the positive
    half of the windowed 2N-point FFT kept, so that its rows are as wide
    as fft_cc's.  The state is the inner fft_cc's."""

    def __init__(self, fft_out_size: int, every_n_samples: int,
                 window: str = firdes.WINDOW_DEFAULT):
        super().__init__("fft_fc")
        self.fft_out_size = fft_out_size
        self.inner = FftCcBlock(2 * fft_out_size, every_n_samples, window)

    def init(self, device="cuda"):
        return self.inner.init(device)

    def forward(self, tail, x):
        x = x.to(torch.float32)
        tail, spectra = self.inner(tail, torch.complex(x, torch.zeros_like(x)))
        return tail, spectra[..., : self.fft_out_size]


def fft_fc_block(fft_out_size: int, every_n_samples: int,
                 window: str = firdes.WINDOW_DEFAULT) -> Block:
    return FftFcBlock(fft_out_size, every_n_samples, window)


def logaveragepower_cf(spectra: torch.Tensor, add_db: float,
                       avgnumber: int) -> torch.Tensor:
    """Average groups of ``avgnumber`` power frames, then log (reference
    csdr.c:1663-1695, with its add_db -= 10*log10(avgnumber)).
    (B, fft) with B a multiple of avgnumber -> (B/avgnumber, fft) float32.
    The offset is formed in float64 and rounded to float32 once, as it
    enters csdr_tpu's program as one float32 constant."""
    b, n = spectra.shape
    p = _abs2(spectra).reshape(b // avgnumber, avgnumber, n).sum(dim=1)
    return log_ff(p, float(np.float32(add_db - 10.0 * np.log10(avgnumber))))


class LogaveragepowerBlock(Block):
    """The flat form the CLI pumps: the chunk as (B, fft_size) rows,
    groups of ``avgnumber`` averaged, the rows out flat."""

    def __init__(self, add_db: float, fft_size: int, avgnumber: int):
        super().__init__("logaveragepower_cf")
        self.add_db, self.fft_size, self.avgnumber = add_db, fft_size, \
            avgnumber

    def forward(self, state, x):
        sp = x.reshape(-1, self.fft_size)
        return state, logaveragepower_cf(sp, self.add_db,
                                         self.avgnumber).reshape(-1)


def logaveragepower_block(add_db: float, fft_size: int,
                          avgnumber: int) -> Block:
    return LogaveragepowerBlock(add_db, fft_size, avgnumber)


def compress_fft_adpcm_rows(rows: torch.Tensor, fft_size: int):
    """The reference's compress_fft_adpcm_f_u8 over (B, fft) waterfall rows,
    each from a fresh codec state (csdr.c:1745-1768) -> (B, bytes) uint8,
    one codec launch for all rows.  ``fft_size`` is csdr_tpu's argument,
    unused there as here."""
    return adpcm.compress_fft_adpcm_f_u8(rows, fft_size)
