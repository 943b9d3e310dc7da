"""Modulators (counterpart of csdr_tpu.ops.mod): FM, DSB and the rpitx
sample format.

fmmod's phase accumulator is a cumulative sum over the chunk, as in
csdr_tpu, in place of the reference's serial loop (libcsdr.c:1180-1192);
the carried phase is csdr_tpu's: the chunk's last phase wrapped into
[-pi, pi).  ``convert_f_samplerf`` packs bytes for a file or pipe sink and
runs on the host, as csdr_tpu's does.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core.block import Block, resolve_device
from csdr_tpu_torch.core.cplx import expj


def fmmod_fc(x: torch.Tensor, last_phase=0.0):
    """FM modulator: phase += x[i]*pi a sample, out = e^{j phase}
    (reference libcsdr.c:1180-1192).  Returns (y complex64, next_phase
    float32 0-dim on x's device)."""
    steps = x.float() * np.pi
    last = torch.as_tensor(last_phase, dtype=torch.float32, device=x.device)
    phase = last + torch.cumsum(steps, 0)
    nxt = torch.remainder(phase[-1] + np.pi, 2 * np.pi) - np.pi
    return expj(phase), nxt


class FmmodBlock(Block):
    """Streaming fmmod_fc; state the carried phase."""

    def __init__(self):
        super().__init__("fmmod_fc")

    def init(self, device="cuda"):
        return torch.zeros((), dtype=torch.float32,
                           device=resolve_device(device))

    def forward(self, phase, x):
        y, phase = fmmod_fc(x, phase)
        return phase, y


def fmmod_block() -> Block:
    return FmmodBlock()


def dsb_fc(x: torch.Tensor, q_value: float = 0.0) -> torch.Tensor:
    """Real -> complex with a constant Q (reference csdr.c:2084-2102)."""
    x = x.float()
    return torch.complex(x, torch.full_like(x, q_value))


def convert_f_samplerf(x, wait_for_this_sample: int) -> np.ndarray:
    """Floats -> the rpitx 16-byte record: float64 value, u32 wait, u32
    zero (reference csdr.c:2105-2127).  Host numpy; returns the bytes as
    uint8."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.asarray(x, np.float64)
    out = np.zeros((len(x), 16), np.uint8)
    out[:, 0:8] = x.view(np.uint8).reshape(-1, 8)
    out[:, 8:12] = np.frombuffer(
        np.full(len(x), wait_for_this_sample, np.uint32).tobytes(),
        np.uint8).reshape(-1, 4)
    return out.reshape(-1)
