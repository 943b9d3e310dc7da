"""Gain control (counterpart of csdr_tpu.ops.agc): agc_ff, the full
feedback AGC, in its exact per-sample form and its chunked
waveform-relaxation form; fastagc_ff, the 3-block lookahead AGC; and
simple_agc_cc, the 1-pole AGC.

- ``fastagc_ff`` is block-parallel by construction: elementwise torch ops.
- ``simple_agc_cc``'s per-sample update is affine in the gain, so it runs
  as a log-depth affine scan.
- ``agc_ff`` is a nonlinear per-sample recurrence (hang counters, peak
  memory, attack and decay branches).  Its exact form runs sample by sample
  on the stream's device: one kernel launch a call on the card
  (``kernels/agc_cuda.scan``, ``agc_block(method="scan")``), the numpy
  float32 loop on the CPU.  ``agc_ff_chunked`` is the form the receivers
  use: per-chunk affine scans relaxed to a fixpoint of their branch masks,
  one kernel launch a call on the card (``kernels/agc_cuda.relax``).
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core.block import Block, resolve_device
from csdr_tpu_torch.core.scan import affine_scan
from csdr_tpu_torch.kernels import agc_cuda

FASTAGC_MAX_GAIN = 50.0  # reference libcsdr.c:943


def fastagc_ff(state, x: torch.Tensor, reference: float = 1.0):
    """One block step of the 3-block lookahead AGC (reference
    libcsdr.c:946-991).

    state = (buffer_1, buffer_2, peak_1, peak_2, last_gain); the buffers
    are as long as ``x``.  Returns (state', output), the output being the
    gain-ramped buffer_1 (two blocks of latency, as in the reference)."""
    buffer_1, buffer_2, peak_1, peak_2, last_gain = state
    n = x.shape[0]
    peak_input = x.abs().max()
    target_peak = torch.maximum(peak_input, torch.maximum(peak_1, peak_2))
    target_gain = torch.clamp(reference / target_peak, max=FASTAGC_MAX_GAIN)
    rate = torch.arange(n, dtype=torch.float32, device=x.device) / n
    gain = last_gain * (1.0 - rate) + target_gain * rate
    return (buffer_2, x, peak_2, peak_input, target_gain), buffer_1 * gain


class FastagcBlock(Block):
    """Streaming fastagc_ff.  Every chunk must be ``block_size`` samples;
    warmup_out = 2*block_size (the lookahead fill)."""

    def __init__(self, reference: float = 1.0, block_size: int | None = None):
        super().__init__("fastagc_ff")
        self.reference = reference
        self.block_size = block_size
        self.warmup_out = 2 * (block_size or 0)

    def init(self, device="cuda"):
        if not self.block_size:
            raise ValueError("fastagc_block needs block_size")
        dev = resolve_device(device)
        z = torch.zeros(self.block_size, dtype=torch.float32, device=dev)

        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)
        return (z, z.clone(), scalar(0.0), scalar(0.0), scalar(1.0))

    def forward(self, state, x):
        if x.shape[0] != self.block_size:
            raise ValueError(f"fastagc_ff: chunk of {x.shape[0]} samples, "
                             f"block_size {self.block_size}")
        return fastagc_ff(state, x.float(), self.reference)


def fastagc_block(reference: float = 1.0,
                  block_size: int | None = None) -> Block:
    return FastagcBlock(reference, block_size)


def simple_agc_cc(x: torch.Tensor, rate: float, reference: float = 1.0,
                  max_gain: float = 65535.0, current_gain=1.0):
    """reference libcsdr.c:2201-2217.  Per sample:
      ideal = clip(reference/|x|, 0, max_gain)   (|x| = 0: the reference's
                                                  ref/0 = +inf clamps DOWN
                                                  to max_gain)
      g     = g*(1-2*rate) + rate*ideal
      y     = g*x
    Affine in g, so a scan.  Returns (y, next_gain)."""
    amp = x.abs()
    zero = amp == 0
    ideal = torch.where(zero, max_gain, torch.clamp(
        reference / torch.where(zero, 1.0, amp), 0.0, max_gain))
    g0 = torch.as_tensor(current_gain, dtype=torch.float32, device=x.device)
    g = affine_scan(torch.full_like(amp, np.float32(1.0 - 2.0 * rate)),
                     rate * ideal, g0)
    return x * g, g[-1].clone()


class SimpleAgcBlock(Block):
    def __init__(self, rate: float, reference: float = 1.0,
                 max_gain: float = 65535.0):
        super().__init__("simple_agc_cc")
        self.rate, self.reference, self.max_gain = rate, reference, max_gain

    def init(self, device="cuda"):
        return torch.ones((), dtype=torch.float32,
                          device=resolve_device(device))

    def forward(self, gain, x):
        y, gain = simple_agc_cc(x, self.rate, self.reference, self.max_gain,
                                gain)
        return gain, y


def simple_agc_block(rate: float, reference: float = 1.0,
                     max_gain: float = 65535.0) -> Block:
    return SimpleAgcBlock(rate, reference, max_gain)


# ---------------------------------------------------------------------------
# agc_ff: the exact recurrence
# ---------------------------------------------------------------------------

def _first_peak(reference, last_gain):
    """The peak memory's start, reference/last_gain rounded once to float32
    (the quotient of the float32 gain in double, as csdr_tpu's host value
    divides): on the card when the gain is there, else on the host."""
    if isinstance(last_gain, torch.Tensor) and last_gain.device.type != "cpu":
        ref = torch.full((), float(reference), dtype=torch.float64,
                         device=last_gain.device)
        return (ref / last_gain.reshape(()).double()).float()
    g = np.float32(last_gain.item() if isinstance(last_gain, torch.Tensor)
                   else last_gain)
    return np.float32(float(reference) / float(g))


def _on_card(v, dtype, dev):
    """A state value as the kernel takes it: a tensor already on ``dev``
    as it is, a number or CPU tensor uploaded (one-shot calls; a streaming
    block carries its state on the card and uploads nothing)."""
    if isinstance(v, torch.Tensor):
        if v.device != torch.device("cpu"):
            return v
        v = v.item()
    v = np.float32(v) if dtype == torch.float32 else int(v)
    return torch.tensor(v, dtype=dtype, device=dev)


def agc_ff(x: torch.Tensor, reference=0.2, attack_rate=0.01,
           decay_rate=0.0001, max_gain=65536.0, hang_time=200,
           attack_wait_time=0, gain_filter_alpha=0.999, last_gain=1.0,
           last_hang=0, last_peak=None, last_awc=0, started=False,
           full_state=False):
    """Full AGC with hang/attack-wait and the gain IIR (reference
    libcsdr_gpl.c:163-260), one sample at a time in float32 on the
    stream's device: one launch of ``kernels/agc_cuda.scan``'s kernel on
    the card, its plain version (the numpy loop) on the CPU.  Defaults are
    the reference CLI's (csdr.c:2018-2044).

    Returns (y, next_gain), or (y, next_gain, next_hang, next_peak,
    next_awc) with full_state=True, the state scalars 0-dim tensors on the
    stream's device.  Streaming callers thread all of it plus
    ``started=True`` after the first chunk, which makes the output
    independent of the chunking: the reference's skip of sample 0 (output
    last_gain*input[0], state unchanged) applies only at the true stream
    start, as in csdr_tpu.  Otherwise sample for sample the reference,
    including output[0] = last_gain*input[0] and the "dc-pass" gain filter
    y_gain = gain + last_gain - alpha*last_gain."""
    x = x.float()
    if last_peak is None:
        last_peak = _first_peak(reference, last_gain)
    state = (last_gain, last_hang, last_peak, last_awc)
    if x.is_cuda:
        state = tuple(_on_card(v, dtype, x.device) for v, dtype in zip(
            state, (torch.float32, torch.int32, torch.float32, torch.int32)))
    y, g, h, p, a = agc_cuda.scan(
        x, *state, started, reference, attack_rate, decay_rate, max_gain,
        hang_time, attack_wait_time, gain_filter_alpha)
    return (y, g, h, p, a) if full_state else (y, g)


# ---------------------------------------------------------------------------
# agc_ff_chunked: the waveform relaxation
# ---------------------------------------------------------------------------

def agc_ff_chunked(x: torch.Tensor, reference=0.2, attack_rate=0.01,
                   decay_rate=0.0001, max_gain=65536.0, hang_time=200,
                   gain_filter_alpha=0.999, last_gain=1.0, last_hang=0,
                   started=False, chunk: int = 8192, iters: int = 14,
                   check: bool = True):
    """agc_ff (attack_wait_time=0) as a waveform relaxation over chunks of
    ``chunk`` samples, on the stream's device (csdr_tpu.ops.agc
    agc_ff_chunked, which holds it to agc_ff).

    Carrying f, the filtered gain, each reference step is affine in f once
    its branch is known (attack, decay, hang-frozen decay, or the max_gain
    clip), and the branches depend on f only through ref/|x| < f.  All
    chunks run in parallel: an inner relaxation derives the branch masks
    from a trajectory and re-runs one affine scan, to the fixpoint of the
    masks; an outer relaxation passes each chunk's exit gain and hang to
    the next chunk as its entry, until the entries agree to 1e-6 relative.

    On the card both relaxations are one kernel launch
    (``kernels/agc_cuda.relax``, ``csrc/agc.cu``: a chunk stops at the
    first round whose masks equal the round's before, as csdr_tpu's does;
    no host sync, no scalar upload; ``chunk`` at most 8192).  On the CPU
    the plain version (``agc_cuda.relax_plain``) runs a fixed ``iters``
    inner rounds, which gives the same bits, and one host sync an outer
    round.

    Returns (y, next_gain, next_hang, converged); thread next_gain and
    next_hang, and ``started=True`` after the first chunk.  ``converged``
    (a 0-dim bool tensor) is mask self-consistency with agreed boundary
    gains; a borderline float tie can make it False with an equivalent
    trajectory, so it is a diagnostic, not a failure bit.  ``check=False``
    returns None in its place."""
    return agc_cuda.relax(x, reference, attack_rate, decay_rate, max_gain,
                          hang_time, gain_filter_alpha, last_gain, last_hang,
                          started, chunk, iters, check)


class AgcBlock(Block):
    """Streaming agc_ff.  method="chunked" (the default) runs
    agc_ff_chunked, state (gain, hang, started); method="scan" runs the
    exact recurrence (one launch of the exact kernel a chunk on the card),
    state (gain, hang, peak, attack-wait, started).  Both run on the
    stream's device, carry the whole recurrence state and the ``started``
    flag, so the output does not depend on the chunking and the two methods
    agree across chunk boundaries.  ``started`` is a host flag (a 0-dim CPU
    tensor): it depends only on the chunk lengths."""

    def __init__(self, method: str = "chunked", **params):
        super().__init__("agc_ff")
        if method not in ("chunked", "scan"):
            raise ValueError(f"agc method {method!r}: 'chunked' or 'scan'")
        if method == "chunked":
            if params.get("attack_wait_time", 0) != 0:
                raise ValueError("chunked agc supports attack_wait_time=0 "
                                 "only; use method='scan'")
            if (params.get("attack_rate", 0.01) > 1.0
                    or params.get("decay_rate", 0.001) > 1.0):
                raise ValueError("chunked agc models the gain>=0 clamp only "
                                 "for rates <= 1; use method='scan'")
        self.method, self.params = method, params

    def init(self, device="cuda"):
        dev = resolve_device(device)
        g = self.params.get("last_gain", 1.0)
        started = torch.tensor(False)
        gain = torch.tensor(g, dtype=torch.float32, device=dev)
        hang = torch.zeros((), dtype=torch.int32, device=dev)
        if self.method == "chunked":
            return gain, hang, started
        peak = torch.tensor(np.float32(self.params.get("reference", 0.2) / g),
                            device=dev)
        return (gain, hang, peak, torch.zeros((), dtype=torch.int32,
                                              device=dev), started)

    def forward(self, state, x):
        p = dict(self.params)
        p["last_gain"], p["last_hang"] = state[0], state[1]
        started = torch.tensor(bool(state[-1]) or x.shape[0] > 0)
        if self.method == "chunked":
            p.pop("attack_wait_time", None)
            y, gain, hang, _ = agc_ff_chunked(x, started=bool(state[-1]),
                                              check=False, **p)
            return (gain, hang, started), y
        y, gain, hang, peak, awc = agc_ff(
            x, full_state=True, last_peak=state[2], last_awc=state[3],
            started=bool(state[-1]), **p)
        return (gain, hang, peak, awc, started), y


def agc_block(method: str = "chunked", **params) -> Block:
    return AgcBlock(method, **params)
