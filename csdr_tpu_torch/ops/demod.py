"""Analog demodulators and de-emphasis (counterpart of csdr_tpu.ops.demod):
FM (quadri-correlator and phase difference), AM (magnitude and its
estimator), the SSB real part, and the WFM and NFM de-emphasis filters.

The discriminator is elementwise with a one-sample carry.  The WFM
de-emphasis 1-pole IIR runs, as in csdr_tpu, as the short FIR it equals at
audio rates (its impulse response dies below 1e-8 within K taps), or as an
affine prefix scan when K would exceed 256 taps.  The NFM de-emphasis is a
fixed FIR per audio rate with its input tail carried.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch import firdes
from csdr_tpu_torch.core.block import Block, VarOut, resolve_device
from csdr_tpu_torch.core.scan import affine_scan
from csdr_tpu_torch.ops.fir import apply_real_fir_ff

# Reference scaling constant (libcsdr.c:1020-1021):
FMDEMOD_QUADRI_K = 0.340447550238101026565118445432744920253753662109375


def fmdemod_quadri_cf(x: torch.Tensor, last_sample=None):
    """Quadri-correlator FM discriminator (reference libcsdr.c:1039-1071):
    y = K*(i*dq - q*di)/(i^2+q^2), dq/di against the previous sample; the
    first sample differentiates against ``last_sample`` (0 at stream
    start).  Along the last axis; leading axes are independent streams,
    each with its ``last_sample``.  Returns (y float32, new_last_sample
    complex64, x's shape without its last axis)."""
    if last_sample is None:
        last_sample = torch.zeros(x.shape[:-1], dtype=torch.complex64,
                                  device=x.device)
    prev = torch.cat([last_sample[..., None], x[..., :-1]], -1)
    re, im = x.real, x.imag
    di = re - prev.real
    dq = im - prev.imag
    num = re * dq - im * di
    den = re * re + im * im
    nz = den != 0
    # guard the division itself: torch.where evaluates both branches
    y = torch.where(nz, FMDEMOD_QUADRI_K * num
                    / torch.where(nz, den, torch.ones_like(den)),
                    torch.zeros_like(den))
    return y, x[..., -1].clone()


class FmdemodQuadriBlock(Block):
    def __init__(self):
        super().__init__("fmdemod_quadri_cf")

    def init(self, device="cuda"):
        return torch.zeros((), dtype=torch.complex64,
                           device=resolve_device(device))

    def forward(self, last, x):
        y, last = fmdemod_quadri_cf(x, last)
        return last, y


def fmdemod_quadri_block() -> Block:
    return FmdemodQuadriBlock()


def fmdemod_atan_cf(x: torch.Tensor, last_phase=0.0):
    """Phase-difference discriminator (reference libcsdr.c:1004-1019):
    y = wrap(arg(x[n]) - arg(x[n-1]))/pi, arg = atan2(q, i) as the
    reference's argof.  Returns (y float32, next last_phase float32
    0-dim)."""
    phase = torch.atan2(x.imag, x.real)
    last = torch.as_tensor(last_phase, dtype=torch.float32, device=x.device)
    d = phase - torch.cat([last.reshape(1), phase[:-1]])
    d = torch.where(d < -np.pi, d + 2 * np.pi, d)
    d = torch.where(d > np.pi, d - 2 * np.pi, d)
    return d / np.pi, phase[-1].clone()


class FmdemodAtanBlock(Block):
    """Streaming fmdemod_atan_cf; state the last sample's phase."""

    def __init__(self):
        super().__init__("fmdemod_atan_cf")

    def init(self, device="cuda"):
        return torch.zeros((), dtype=torch.float32,
                           device=resolve_device(device))

    def forward(self, last, x):
        y, last = fmdemod_atan_cf(x, last)
        return last, y


def fmdemod_atan_block() -> Block:
    return FmdemodAtanBlock()


def amdemod_cf(x: torch.Tensor) -> torch.Tensor:
    """Magnitude AM demod (reference libcsdr.c:861-873)."""
    return x.abs()


def amdemod_estimator_cf(x: torch.Tensor, alpha: float = 0.0,
                         beta: float = 0.0) -> torch.Tensor:
    """alpha*max(|i|,|q|) + beta*min(|i|,|q|) magnitude estimate
    (reference libcsdr.c:875-901; the defaults minimize the RMS error)."""
    if alpha == 0:
        alpha, beta = 0.947543636291, 0.392485425092
    ai, aq = x.real.abs(), x.imag.abs()
    return alpha * torch.maximum(ai, aq) + beta * torch.minimum(ai, aq)


def realpart_cf(x: torch.Tensor) -> torch.Tensor:
    """SSB demod tail: take I (reference csdr.c:634-645)."""
    return x.real


def _one_pole_scan(x, alpha, y0):
    """y[n] = alpha*x[n] + (1-alpha)*y[n-1]."""
    b = torch.full_like(x, 1.0 - alpha)
    return affine_scan(b, alpha * x, y0)


def _one_pole_scan_masked(x, alpha, y0, mask):
    """Masked 1-pole: invalid samples are identity elements (1, 0), so the
    carry skips them (how VarOut streams flow through IIRs)."""
    b = torch.where(mask, torch.full_like(x, 1.0 - alpha),
                    torch.ones_like(x))
    a = torch.where(mask, alpha * x, torch.zeros_like(x))
    return affine_scan(b, a, y0)


def deemphasis_wfm_ff(x, tau, sample_rate, last_output=0.0):
    """WFM de-emphasis: 1-pole IIR LPF, alpha = dt/(tau+dt)
    (reference libcsdr.c:1081-1097).  Returns (y, next_last_output)."""
    dt = 1.0 / sample_rate
    alpha = dt / (tau + dt)
    y = _one_pole_scan(x.float(), alpha, last_output)
    return y, y[-1]


class DeemphasisWfmBlock(Block):
    """Streaming WFM de-emphasis.

    At audio alphas the IIR's impulse response a*b^j dies below f32
    resolution within K taps, so the recurrence is the K-tap FIR
    y[n] = sum_{j<K} a*b^j x[n-j], with the K-1 input tail as its state.
    When K would exceed 256 taps it runs as the affine scan instead, with
    the last output as its state.  VarOut inputs: only the valid prefix
    [0, count) feeds the carry."""

    def __init__(self, tau: float, sample_rate: int):
        super().__init__("deemphasis_wfm_ff")
        dt = 1.0 / sample_rate
        self.tau, self.sample_rate = tau, sample_rate
        self.alpha = alpha = dt / (tau + dt)
        b = 1.0 - alpha
        # kf >= 2 so the carried tail is never 0-length
        k_needed = max(2, int(np.ceil(np.log(1e-8) / np.log(max(b, 1e-12))))) \
            if 0.0 < b < 1.0 else 2
        self.use_fir = k_needed <= 256
        self.kf = k_needed
        # correlation-form taps: T[t] = a*b^(K-1-t) puts the newest sample
        # at weight a
        self.taps = (alpha * np.power(b, np.arange(k_needed - 1, -1, -1))
                     ).astype(np.float32)

    def init(self, device="cuda"):
        dev = resolve_device(device)
        if self.use_fir:
            return torch.zeros(self.kf - 1, dtype=torch.float32, device=dev)
        return torch.zeros((), dtype=torch.float32, device=dev)

    def forward(self, state, x):
        data = x.data if isinstance(x, VarOut) else x
        if not self.use_fir:
            if isinstance(x, VarOut):
                mask = torch.arange(data.shape[0], device=data.device) \
                    < x.count
                y = _one_pole_scan_masked(data.float(), self.alpha, state,
                                          mask)
                last = y[x.count - 1] if x.count else state
                return last, VarOut(y, x.count)
            y, last = deemphasis_wfm_ff(data, self.tau, self.sample_rate,
                                        state)
            return last, y
        xcat = torch.cat([state, data.float()])
        y = apply_real_fir_ff(xcat, self.taps)[: data.shape[0]]
        if isinstance(x, VarOut):
            # valid samples are the prefix [0, count): the last K-1 valid
            # inputs start at xcat[count]
            return (xcat[x.count: x.count + self.kf - 1].clone(),
                    VarOut(y, x.count))
        return xcat[-(self.kf - 1):].clone(), y


def deemphasis_wfm_block(tau: float, sample_rate: int) -> Block:
    return DeemphasisWfmBlock(tau, sample_rate)


def deemphasis_nfm_ff(x: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """NFM de-emphasis: the fixed FIR of the audio rate (reference
    libcsdr.c:1099-1128 and predefined.h), stateless valid mode."""
    return apply_real_fir_ff(x.float(), firdes.deemphasis_nfm_taps(sample_rate))


class DeemphasisNfmBlock(Block):
    """Streaming NFM de-emphasis: the FIR with its T-1 input tail carried.
    warmup_out = T-1."""

    def __init__(self, sample_rate: int):
        super().__init__("deemphasis_nfm_ff")
        self.taps = firdes.deemphasis_nfm_taps(sample_rate)
        self.warmup_out = len(self.taps) - 1

    def init(self, device="cuda"):
        return torch.zeros(len(self.taps) - 1, dtype=torch.float32,
                           device=resolve_device(device))

    def forward(self, tail, x):
        n = x.shape[0]
        xcat = torch.cat([tail, x.float()])
        y = apply_real_fir_ff(xcat, self.taps)[:n]
        return xcat[n:].clone(), y


def deemphasis_nfm_block(sample_rate: int) -> Block:
    return DeemphasisNfmBlock(sample_rate)
