"""Noise and test-signal sources (counterpart of csdr_tpu.ops.noise).

The reference seeds from /dev/urandom (libcsdr.c:2444-2476) and replays
through --awgnfile (csdr.c:3042-3046); here every random source takes a
seed and draws from its own ``torch.Generator`` on the output's device.
The streams are not csdr_tpu's threefry streams: the same seed gives
other samples with the same statistics.  Everything else (the amplitude
split of :func:`awgn_cc`, the constant and repeat sources) is exactly
csdr_tpu's.
"""

from __future__ import annotations

import torch

from csdr_tpu_torch.core.block import resolve_device


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def uniform_noise_f(n: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """Uniform float32 in [-1, 1) (reference uniform_noise_f)."""
    dev = resolve_device(device)
    u = torch.rand(n, generator=_generator(seed, dev), device=dev)
    return u * 2.0 - 1.0


def gaussian_noise_c(n: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """Complex gaussian with unit variance per component (reference
    get_random_gaussian_samples_c, Box-Muller, libcsdr.c:2458-2470)."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    re = torch.randn(n, generator=g, device=dev)
    im = torch.randn(n, generator=g, device=dev)
    return torch.complex(re, im)


def awgn_cc(x: torch.Tensor, snr_db: float, seed: int = 0) -> torch.Tensor:
    """Add noise at ``snr_db`` with the reference's amplitude split
    (csdr.c:3050-3052): r = 10^(snr/20); out = x*r/(r+1) + noise/(r+1),
    the noise scaled by a further 0.707 per component (csdr.c:3080) so
    that the complex noise power is a_noise^2.  The noise is drawn on
    ``x``'s device."""
    r = 10.0 ** (snr_db / 20.0)
    a_signal = r / (r + 1.0)
    a_noise = 0.707 / (r + 1.0)
    nz = gaussian_noise_c(x.shape[-1], seed, x.device)
    return torch.complex(x.real * a_signal + nz.real * a_noise,
                         x.imag * a_signal + nz.imag * a_noise)


def yes_f(value: float, n: int, device="cuda") -> torch.Tensor:
    """Constant source (reference csdr.c:687-702)."""
    return torch.full((n,), value, dtype=torch.float32,
                      device=resolve_device(device))


def repeat_u8(pattern, n_repeats: int, device="cuda") -> torch.Tensor:
    """A byte pattern repeated (reference csdr.c:3018-3033)."""
    p = torch.as_tensor(pattern, dtype=torch.uint8,
                        device=resolve_device(device))
    return p.repeat(n_repeats)


def add_n_zero_samples_at_beginning_f(x: torch.Tensor,
                                      n_zero: int) -> torch.Tensor:
    """reference csdr.c add_n_zero_samples_at_beginning_f"""
    return torch.cat([x.new_zeros(n_zero), x])
