"""The carrier recovery loops on the card: the BPSK Costas loop and the PLL
(the counterparts of csdr_tpu's ``lax.scan``s in csdr_tpu/ops/sync.py:142
and :67); no Pallas kernel there.

csdr_tpu compiles each loop over the samples into one device loop.  In
eager torch each was a Python loop of ~20 small ops a sample (~1.15 M
launches a chunk of BASELINE config 5 with the Costas loop), so they are
hand-written CUDA, ``csrc/carrier.cu``: one warp a row with one thread
carrying the recurrence, one launch a call, the state in and out as
tensors on the card (no host read, no scalar upload).  On the card each
kernel gives its plain version's bits: every torch op of the loop is one
rounded operation there, in the loop's order, with the CUDA math
library's cosf, sinf and atan2f (what torch calls on float32 on the card).

:func:`costas` takes complex64 ``x`` (..., n), the loop constants and the
state (nco_phase, freq, dphase) per row and returns (y, error, dphase,
state'); :func:`pll` takes ``x``, alpha, beta (None: the P controller) and
the state (output_phase, dphase, iir) and returns (-dphase, the NCO sin +
j*cos, state').  :func:`costas_cycles` and :func:`pll_cycles` measure on
the card each loop's chain, which bounds it.

The wrappers launch their kernels for CUDA tensors, or raise; they take
the plain versions (:func:`costas_plain`, :func:`pll_plain`: the loops of
torch ops, any device) only for CPU tensors.  ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from csdr_tpu_torch.kernels import _build

LAUNCHES = {"costas_scan": 0, "pll_scan": 0}
PROBE_MAX = 2048        # samples a chain probe stages (csrc/carrier.cu)
TWO_PI = 2.0 * np.pi


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def wrap_pi(p: torch.Tensor) -> torch.Tensor:
    """while(p>pi) p-=2pi; while(p<-pi) p+=2pi;"""
    return torch.remainder(p + np.pi, TWO_PI) - np.pi


def loop_state(state, shape, device) -> tuple:
    """Three float32 loop scalars per row on ``device``, from numbers (a
    fill there: nothing uploaded) or tensors."""
    return tuple(v.to(device, torch.float32).expand(shape).clone()
                 if isinstance(v, torch.Tensor) else
                 torch.full(shape, float(v), dtype=torch.float32,
                            device=device) for v in state)


def _card_state(state, lead, dev) -> list:
    """The state as the kernels take it: three (rows,) float32 tensors on
    ``dev``, from tensors there (broadcast to the rows) or numbers (a fill
    on the card: nothing uploaded).  A tensor elsewhere raises."""
    rows = math.prod(lead)
    out = []
    for v in state:
        if isinstance(v, torch.Tensor):
            if v.device != dev:
                raise ValueError(f"carrier loop: a state tensor on "
                                 f"{v.device}, the samples on {dev}")
            out.append(v.to(torch.float32).expand(lead).reshape(rows)
                       .contiguous())
        else:
            out.append(torch.full((rows,), float(v), dtype=torch.float32,
                                  device=dev))
    return out


def _rows(x: torch.Tensor, what: str):
    """(x as (rows, n) complex64 contiguous, the leading shape, n)."""
    if x.dtype != torch.complex64:
        raise TypeError(f"{what}: want complex64 samples, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1 or x.numel() == 0:
        raise ValueError(f"{what}: want samples (..., n), n >= 1, got "
                         f"{tuple(x.shape)}")
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    if n >= 1 << 31:
        raise ValueError(f"{what}: {n} samples a row, past int32")
    return x.reshape(math.prod(lead), n).contiguous(), lead, n


def _f32(v) -> float:
    return float(np.float32(float(v)))


def _on_cpu(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cpu":
        raise ValueError(f"{what}: runs on CPU or CUDA tensors, not "
                         f"{x.device}")


# ---------------------------------------------------------------------------
# the Costas loop (reference libcsdr.c:2108-2142)
# ---------------------------------------------------------------------------

def costas(x: torch.Tensor, alpha, beta, dphase_max,
           decision_directed: bool = False,
           dphase_max_reset_to_zero: bool = False, state=(0.0, 0.0, 0.0)):
    """The Costas loop over complex64 ``x`` (..., n); state = (nco_phase,
    freq, dphase) per row, numbers or tensors shaped ``x.shape[:-1]``.
    Returns (y complex64, error, dphase_out, state').  A CUDA tensor
    launches the kernel; a CPU tensor takes :func:`costas_plain`."""
    if not x.is_cuda:
        _on_cpu(x, "costas")
        return costas_plain(x, alpha, beta, dphase_max, decision_directed,
                            dphase_max_reset_to_zero, state)
    xs, lead, n = _rows(x, "costas")
    st = _card_state(state, lead, x.device)
    y, err, dph, out = _costas_launch(xs, alpha, beta, dphase_max,
                                      decision_directed,
                                      dphase_max_reset_to_zero, st)
    LAUNCHES["costas_scan"] += 1
    return (y.reshape(x.shape), err.reshape(x.shape), dph.reshape(x.shape),
            tuple(t.reshape(lead) for t in out))


def _costas_launch(xs, alpha, beta, dmax, dd, reset, st):
    rows, n = xs.shape
    dev = xs.device
    y = torch.empty_like(xs)
    err = torch.empty((rows, n), dtype=torch.float32, device=dev)
    dph = torch.empty_like(err)
    out = [torch.empty(rows, dtype=torch.float32, device=dev)
           for _ in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_build.lib().csdr_costas_scan(
        xs.data_ptr(), rows, n, _f32(alpha), _f32(beta), _f32(dmax),
        int(bool(dd)), int(bool(reset)), *(t.data_ptr() for t in st),
        y.data_ptr(), err.data_ptr(), dph.data_ptr(),
        *(t.data_ptr() for t in out), stream), "costas_scan")
    return y, err, dph, out


def costas_plain(x: torch.Tensor, alpha, beta, dphase_max,
                 decision_directed: bool = False,
                 dphase_max_reset_to_zero: bool = False,
                 state=(0.0, 0.0, 0.0)):
    """:func:`costas` as a Python loop of torch ops on ``x``'s device, a
    sample a step."""
    nco_phase, freq, dphase = loop_state(state, x.shape[:-1], x.device)
    re, im = x.real, x.imag
    yr, yi, errs, dphs = [], [], [], []
    for i in range(x.shape[-1]):
        nco_re = torch.cos(nco_phase)
        nco_im = torch.sin(nco_phase)
        xr, xi = re[..., i], im[..., i]
        y_re = xr * nco_re - xi * nco_im
        y_im = xr * nco_im + xi * nco_re
        if decision_directed:
            op = torch.atan2(y_im, y_re)
            error = torch.where(torch.abs(op) < np.pi / 2, -op,
                                wrap_pi(np.pi - op))
        else:
            error = np.pi * y_re * y_im
        freq = freq + error * beta
        dphase = error * alpha + freq
        if dphase_max_reset_to_zero:
            dphase = torch.where(torch.abs(dphase) > dphase_max, 0.0, dphase)
        else:
            dphase = torch.clamp(dphase, -dphase_max, dphase_max)
        # while(nco_phase > 2pi) -= 2pi; while(nco_phase <= 0) += 2pi
        nco_phase = torch.remainder(nco_phase + dphase, TWO_PI)
        nco_phase = torch.where(nco_phase <= 0, nco_phase + TWO_PI, nco_phase)
        yr.append(y_re)
        yi.append(y_im)
        errs.append(error)
        dphs.append(dphase)
    y = torch.complex(torch.stack(yr, -1), torch.stack(yi, -1))
    return (y, torch.stack(errs, -1), torch.stack(dphs, -1),
            (nco_phase, freq, dphase))


# ---------------------------------------------------------------------------
# the PLL (reference libcsdr.c:1870-1915)
# ---------------------------------------------------------------------------

def pll(x: torch.Tensor, alpha, beta=None, state=(0.0, 0.0, 0.0)):
    """The PLL over complex64 ``x`` (..., n): atan2 phase detector, P
    (beta None) or PI loop filter; state = (output_phase, dphase, iir) per
    row.  Returns (-dphase float32, nco complex64 sin + j*cos, state').  A
    CUDA tensor launches the kernel; a CPU tensor takes
    :func:`pll_plain`."""
    if not x.is_cuda:
        _on_cpu(x, "pll")
        return pll_plain(x, alpha, beta, state)
    xs, lead, n = _rows(x, "pll")
    st = _card_state(state, lead, x.device)
    dph, nco, out = _pll_launch(xs, alpha, beta, st)
    LAUNCHES["pll_scan"] += 1
    return (dph.reshape(x.shape), nco.reshape(x.shape),
            tuple(t.reshape(lead) for t in out))


def _pll_launch(xs, alpha, beta, st):
    rows, n = xs.shape
    dev = xs.device
    dph = torch.empty((rows, n), dtype=torch.float32, device=dev)
    nco = torch.empty_like(xs)
    out = [torch.empty(rows, dtype=torch.float32, device=dev)
           for _ in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_build.lib().csdr_pll_scan(
        xs.data_ptr(), rows, n, _f32(alpha),
        0.0 if beta is None else _f32(beta), int(beta is not None),
        *(t.data_ptr() for t in st), dph.data_ptr(), nco.data_ptr(),
        *(t.data_ptr() for t in out), stream), "pll_scan")
    return dph, nco, out


def pll_plain(x: torch.Tensor, alpha, beta=None, state=(0.0, 0.0, 0.0)):
    """:func:`pll` as a Python loop of torch ops on ``x``'s device, a
    sample a step.  The reference NCO is sin + j*cos and its detector
    atan2(i, q), mirrored exactly."""
    output_phase, dphase, iir = loop_state(state, x.shape[:-1], x.device)
    re, im = x.real, x.imag
    dph, nr, ni = [], [], []
    for i in range(x.shape[-1]):
        output_phase = wrap_pi(output_phase + dphase)
        nr.append(torch.sin(output_phase))
        ni.append(torch.cos(output_phase))
        input_phase = torch.atan2(re[..., i], im[..., i])
        new_dphase = wrap_pi(input_phase - output_phase)
        if beta is None:
            dphase = new_dphase * alpha
        else:
            dphase = wrap_pi(new_dphase * alpha + iir)
            iir = iir + new_dphase * beta
        dph.append(-dphase)
    nco = torch.complex(torch.stack(nr, -1), torch.stack(ni, -1))
    return torch.stack(dph, -1), nco, (output_phase, dphase, iir)


# ---------------------------------------------------------------------------
# the chain probes (the kernels' bounds)
# ---------------------------------------------------------------------------

def _probe(x: torch.Tensor, what: str):
    if not x.is_cuda:
        raise ValueError(f"{what} chain probe: runs on a CUDA device only")
    if x.dim() != 1 or x.dtype != torch.complex64 \
            or not 0 < x.shape[0] <= PROBE_MAX:
        raise ValueError(f"{what} chain probe: want 1 to {PROBE_MAX} "
                         f"complex64 samples, got {tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    cycles = torch.zeros(1, dtype=torch.int64, device=x.device)
    sink = torch.zeros(4, dtype=torch.float32, device=x.device)
    return x, cycles, sink, torch.cuda.current_stream(x.device).cuda_stream


def _chain_end(what, x, cycles, sink, out) -> float:
    """Cycles a sample; raises unless the chain's last state is the step's
    and the kernel's, bit for bit (the chain is the function)."""
    got = sink[:3].cpu().numpy()
    want = torch.stack(out).reshape(3).cpu().numpy()
    if float(sink[3]) != 1.0:
        raise RuntimeError(f"{what} chain probe: the chain's last state "
                           f"{got.tolist()} is not its step's")
    if got.view(np.uint32).tolist() != want.view(np.uint32).tolist():
        raise RuntimeError(f"{what} chain probe: the chain's last state "
                           f"{got.tolist()} is not the kernel's "
                           f"{want.tolist()}")
    return int(cycles.item()) / x.shape[0]


def costas_cycles(x: torch.Tensor, alpha, beta, dphase_max,
                  decision_directed: bool = False,
                  dphase_max_reset_to_zero: bool = False,
                  state=(0.0, 0.0, 0.0)) -> float:
    """SM cycles a sample of the Costas loop's shortest chain on the card
    (``csrc/carrier.cu``'s probe): one sin/cos range reduction, the
    rotation, the error, the loop filter, and the clamp and the wraps as
    an add and a select of the choices the step's compares made, on one
    thread over ``x`` (at most PROBE_MAX samples on the card, one row)
    from shared memory, from the state given as numbers, timed.  Raises
    if its last state is not the kernel's on the same samples.  Not
    counted in ``LAUNCHES``."""
    x, cycles, sink, stream = _probe(x, "costas")
    a, b, c = (_f32(v) for v in state)
    args = (_f32(alpha), _f32(beta), _f32(dphase_max),
            int(bool(decision_directed)), int(bool(dphase_max_reset_to_zero)))
    _build.check(_build.lib().csdr_costas_chain_probe(
        cycles.data_ptr(), x.data_ptr(), x.shape[0], *args, a, b, c,
        sink.data_ptr(), stream), "costas chain probe")
    st = _card_state((a, b, c), (1,), x.device)
    out = _costas_launch(x[None], alpha, beta, dphase_max, decision_directed,
                         dphase_max_reset_to_zero, st)[3]
    return _chain_end("costas", x, cycles, sink, out)


def pll_cycles(x: torch.Tensor, alpha, beta=None,
               state=(0.0, 0.0, 0.0)) -> float:
    """SM cycles a sample of the PLL's shortest chain on the card
    (``csrc/carrier.cu``'s probe): the loop filter, and the wraps as an
    add and a select of the choices the step's compares made, on one
    thread from the input phases staged in shared memory (the kernel
    computes them, and the NCO's sin and cos, beside the chain), from the
    state given as numbers, timed.  Raises if its last state is not the
    kernel's on the same samples.  Not counted in ``LAUNCHES``."""
    x, cycles, sink, stream = _probe(x, "pll")
    a, b, c = (_f32(v) for v in state)
    _build.check(_build.lib().csdr_pll_chain_probe(
        cycles.data_ptr(), x.data_ptr(), x.shape[0], _f32(alpha),
        0.0 if beta is None else _f32(beta), int(beta is not None), a, b, c,
        sink.data_ptr(), stream), "pll chain probe")
    st = _card_state((a, b, c), (1,), x.device)
    out = _pll_launch(x[None], alpha, beta, st)[2]
    return _chain_end("pll", x, cycles, sink, out)
