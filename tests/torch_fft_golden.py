"""csdr_tpu's natural-order FFT of one N=4096 frame, kept in a file so that
a machine with a card and no JAX can hold the port's kernel against
csdr_tpu (tests/test_torch_kernels.py), and more frames made from that one
by maps whose effect on the spectrum is exact in floating point.

``data/fft_natural_4096.npz`` holds ``x``, a (1, 4096) complex64 frame of
seeded noise, and ``y``, csdr_tpu's ``fft_pallas.fft_natural(x)`` in
interpret mode at precision HIGHEST (~133 dB from the float64 DFT).
tests/test_torch_fft_natural.py recomputes it and holds the file to it;
it writes the file when run from the repo root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_fft_natural.py

This module imports neither jax nor csdr_tpu.
"""

from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().with_name("data") / "fft_natural_4096.npz"
SEED = 4096
_ROT = np.array([1, 1j, -1, -1j], np.complex64)


def golden_input() -> np.ndarray:
    rng = np.random.default_rng(SEED)
    return (rng.standard_normal((1, 4096))
            + 1j * rng.standard_normal((1, 4096))).astype(np.complex64)


def load() -> tuple:
    """(x, y) of the file."""
    with np.load(GOLDEN) as z:
        return z["x"], z["y"]


def _maps(b: int) -> list:
    """Frame i's map (s, c, e): multiply by i**(s*n), conjugate if c, scale
    by 2**e; distinct for b <= 64."""
    return [(i % 4, (i // 4) % 2, i // 8 - 2) for i in range(b)]


def frames(x: np.ndarray, b: int) -> np.ndarray:
    """(b, N) frames from the (1, N) frame ``x``, each by its map: the
    products by 1, i, -1, -i and by powers of two are exact."""
    n = x.shape[-1]
    out = []
    for s, c, e in _maps(b):
        f = x[0] * _ROT[(s * np.arange(n)) % 4]
        f = np.conj(f) if c else f
        out.append(f * np.float32(2.0 ** e))
    return np.stack(out).astype(np.complex64)


def spectra(y: np.ndarray, b: int) -> np.ndarray:
    """The spectra of ``frames(x, b)`` from ``y``, the spectrum of ``x``:
    the factor i**(s*n) rolls the bins by s*N/4, conjugation takes bin k to
    the conjugate of bin -k, a power of two scales; all exact."""
    n = y.shape[-1]
    out = []
    for s, c, e in _maps(b):
        z = np.roll(y[0], s * n // 4)
        z = np.conj(np.roll(z[::-1], 1)) if c else z
        out.append(z * np.float32(2.0 ** e))
    return np.stack(out).astype(np.complex64)
