"""The chunked AGC's waveform relaxation (the counterpart of csdr_tpu's two
``jax.lax.while_loop``s in csdr_tpu/ops/agc.py:385, 437; no Pallas kernel
there).

csdr_tpu compiles both relaxation loops, the inner one over the branch
masks and the outer one over the chunk boundaries, into one device
program.  In eager torch they were Python loops of small ops and a host
sync a round (~2 900 launches a chunk of the SSB and AM receivers' audio),
so they are hand-written CUDA, ``csrc/agc.cu``: one cooperative launch a
call, one block a chunk row, bit for bit :func:`relax_plain`.
:func:`scan_cycles` measures on the card one affine scan of an
8192-sample row as the kernel runs it, which bounds the function.

:func:`relax` takes a 1-D stream and agc_ff's constants (``agc_ff_chunked``
is the entry point) and returns (y, next_gain, next_hang, converged); on
the card every output stays there, with no host sync and no scalar
upload.  The kernel takes a ``chunk`` of at most ``MAX_CHUNK`` samples
(its row, 24 B a sample, lives in shared memory); a larger one raises.
With more rows than the card holds at once (:func:`resident_rows`), each
block runs its rows in turns.

The wrapper launches the kernel for CUDA tensors, or raises; it takes the
plain version only for CPU tensors.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core.scan import affine_scan
from csdr_tpu_torch.kernels import _build

LAUNCHES = {"agc_relax": 0}
MAX_CHUNK = 8192        # samples a row the kernel's shared memory holds
_NEG = -(1 << 30)       # "no attack yet" in the distance scans


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry(v, dtype, dev):
    """An entry state (the gain or the hang) as the kernel takes it:
    (tensor, 0) for a one-element tensor on the stream's device (the kernel
    reads it there), else (None, value) read on the host (a number or a
    CPU tensor)."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(f"agc relax: an entry state of {v.numel()} "
                             f"elements")
        if v.device == dev:
            return v.to(dtype).reshape(1).contiguous(), 0
        if v.device.type != "cpu":
            raise ValueError(f"agc relax: entry state on {v.device}, the "
                             f"stream on {dev}")
        v = v.item()
    return None, (np.float32(v) if dtype == torch.float32
                  else int(np.int32(v)))


def relax(x: torch.Tensor, reference=0.2, attack_rate=0.01,
          decay_rate=0.0001, max_gain=65536.0, hang_time=200,
          gain_filter_alpha=0.999, last_gain=1.0, last_hang=0,
          started=False, chunk: int = 8192, iters: int = 14,
          check: bool = True, rounds: bool = False):
    """agc_ff_chunked's relaxation (ops/agc.py): CUDA tensors launch the
    kernel; CPU tensors take :func:`relax_plain`.  With ``rounds=True`` (the
    card only) a fifth output: (2, B + 2, B) int32 for B rows, the inner
    rounds each row ran in each outer round (0 past the last), then
    whether its masks settled there."""
    if iters < 1:
        raise ValueError(f"agc_ff_chunked: iters={iters} < 1")
    if not x.is_cuda:
        if rounds:
            raise ValueError("agc relax: rounds are the kernel's count, on "
                             "CUDA tensors only")
        return relax_plain(x, reference, attack_rate, decay_rate, max_gain,
                           hang_time, gain_filter_alpha, last_gain,
                           last_hang, started, chunk, iters, check)
    if x.dim() != 1:
        raise TypeError(f"agc relax: want a 1-D stream, got "
                        f"{tuple(x.shape)}")
    chunk = -(-chunk // 128) * 128
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"agc relax: chunk {chunk}: the kernel's shared "
                         f"memory holds 128 to {MAX_CHUNK} samples")
    if int(hang_time) != hang_time:
        raise ValueError(f"agc relax: hang_time {hang_time} is not an "
                         f"integer")
    x = x.float().contiguous()
    dev, n = x.device, x.shape[0]
    if n == 0:
        return (x, torch.as_tensor(last_gain, dtype=torch.float32,
                                   device=dev).reshape(()),
                torch.as_tensor(last_hang, dtype=torch.int32,
                                device=dev).reshape(()),
                torch.tensor(True) if check else None) + (
                    (torch.empty((2, 2, 0), dtype=torch.int32, device=dev),)
                    if rounds else ())
    f0, f0_val = _entry(last_gain, torch.float32, dev)
    h0, h0_val = _entry(last_hang, torch.int32, dev)
    rows = -(-n // chunk)
    y = torch.empty_like(x)
    gain = torch.empty((), dtype=torch.float32, device=dev)
    hang = torch.empty((), dtype=torch.int32, device=dev)
    conv = torch.empty((), dtype=torch.bool, device=dev)
    traj = torch.empty(rows * chunk, dtype=torch.float32, device=dev)
    xstate = torch.empty(9 * rows, dtype=torch.int32, device=dev)
    table = (torch.empty((2, rows + 2, rows), dtype=torch.int32, device=dev)
             if rounds else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.lib().csdr_agc_relax(
        x.data_ptr(), n, chunk, iters, int(hang_time), int(bool(started)),
        np.float32(reference), np.float32(attack_rate),
        np.float32(decay_rate), np.float32(max_gain),
        np.float32(1.0 - gain_filter_alpha),
        None if f0 is None else f0.data_ptr(), f0_val,
        None if h0 is None else h0.data_ptr(), h0_val,
        y.data_ptr(), gain.data_ptr(), hang.data_ptr(), conv.data_ptr(),
        table.data_ptr() if rounds else None, traj.data_ptr(),
        xstate.data_ptr(), stream)
    _build.check(code, "agc_relax")
    LAUNCHES["agc_relax"] += 1
    return (y, gain, hang, conv if check else None) + (
        (table,) if rounds else ())


def resident_rows(chunk: int = 8192) -> int:
    """Rows of ``chunk`` samples the kernel runs at once on the current
    card (blocks a cooperative launch may hold)."""
    got = _build.lib().csdr_agc_relax_resident(-(-chunk // 128) * 128)
    if got < 1:
        raise RuntimeError(f"agc relax: no resident blocks at chunk {chunk}")
    return got


def scan_cycles(scans: int, device="cuda") -> float:
    """SM cycles of one affine scan of an 8192-sample row on one block of
    1024 threads, as the kernel runs it (``csrc/agc.cu``'s probe: ten
    barrier-separated steps through shared memory, three in registers),
    over ``scans`` scans after a first pass.  It relaxes nothing and is not
    counted in ``LAUNCHES``."""
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    if not cycles.is_cuda:
        raise ValueError("agc scan probe: runs on a CUDA device only")
    sink = torch.empty(1024, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(cycles.device).cuda_stream
    _build.check(_build.lib().csdr_agc_scan_probe(
        cycles.data_ptr(), sink.data_ptr(), scans, stream), "agc scan probe")
    return int(cycles.item()) / scans


# ---------------------------------------------------------------------------
# the plain version: the relaxation as torch ops on every chunk at once
# ---------------------------------------------------------------------------

def relax_plain(x: torch.Tensor, reference=0.2, attack_rate=0.01,
                decay_rate=0.0001, max_gain=65536.0, hang_time=200,
                gain_filter_alpha=0.999, last_gain=1.0, last_hang=0,
                started=False, chunk: int = 8192, iters: int = 14,
                check: bool = True):
    """:func:`relax` on tensors: the inner relaxation a fixed ``iters``
    rounds (once the masks reproduce themselves a round returns its input
    bit for bit, so this equals an exit at the first stable round), the
    outer one with a host sync a round to stop it."""
    x = x.float()
    dev, n = x.device, x.shape[0]
    f0 = torch.as_tensor(last_gain, dtype=torch.float32, device=dev
                         ).reshape(())
    h0 = torch.as_tensor(last_hang, dtype=torch.int32, device=dev
                         ).reshape(())
    if n == 0:
        return x, f0, h0, torch.tensor(True) if check else None
    one_m_alpha = np.float32(1.0 - gain_filter_alpha)
    chunk = -(-chunk // 128) * 128
    pad = (-n) % chunk
    xc = torch.cat([x, x.new_zeros(pad)]).reshape(-1, chunk)    # (B, chunk)
    nchunks = xc.shape[0]
    nz = xc != 0
    c = torch.where(nz, reference / torch.clamp(xc.abs(), min=1e-30), 0.0)
    live = nz.clone()
    if not bool(started):
        live[0, 0] = False       # stream start: sample 0 is an identity step

    def scalar(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=dev)
    ar, dr, zero = scalar(np.float32(attack_rate)), \
        scalar(np.float32(decay_rate)), scalar(0.0)
    neg = scalar(_NEG, torch.int32)

    def trajectory_step(f, ef, entry_last):
        """One round for all chunks: the branch masks from trajectory f
        (f_prev is f shifted by one, the chunk's entry gain ef first), then
        one affine scan."""
        f_prev = torch.cat([ef[:, None], f[:, :-1]], 1)
        attack = live & (c < f_prev)
        decay = live & ~attack
        dc = torch.cumsum(decay, 1, dtype=torch.int32)
        last = torch.maximum(torch.cummax(torch.where(attack, dc, neg),
                                          1).values, entry_last[:, None])
        frozen = decay & (last > _NEG // 2) & (dc - last <= hang_time)
        rate = torch.where(attack, ar, torch.where(decay & ~frozen, dr, zero))
        clip_hi = f_prev + rate * (c - f_prev) > max_gain
        a = torch.where(clip_hi, one_m_alpha, (1.0 - rate) + one_m_alpha)
        b = torch.where(clip_hi, np.float32(max_gain), rate * c)
        if not bool(started):
            a[0, 0], b[0, 0] = 1.0, 0.0
        return affine_scan(a, b, ef), attack, clip_hi, dc[:, -1], last[:, -1]

    def relax_inner(ef, eh, f):
        """The inner relaxation at fixed entries (ef, eh) from the seed
        trajectory f; returns it with the exit hangs and whether the last
        round's masks equal the round's before (None unless ``check``)."""
        # entering hang: a virtual attack eh decay steps before the chunk
        entry_last = torch.where(eh > 0, eh - hang_time, neg)
        conv = torch.tensor(False, device=dev) if check else None
        att_p = clip_p = None
        for i in range(iters):
            f, att, clip, dc_e, last_e = trajectory_step(f, ef, entry_last)
            if check and i == iters - 1 and i > 0:
                conv = (att == att_p).all() & (clip == clip_p).all()
            att_p, clip_p = att, clip
        h_out = torch.clamp(torch.where(last_e > _NEG // 2,
                                        hang_time - (dc_e - last_e), 0),
                            0, hang_time).to(torch.int32)
        return f, h_out, conv

    ef = f0.expand(nchunks).clone()
    eh = h0.expand(nchunks).clone()
    frows = f0.expand(nchunks, chunk).clone()
    for _ in range(nchunks + 2):
        # warm start: each round seeds the inner relaxation with the last
        # round's trajectory (round 1's is the flat entry gain)
        frows, houts, conv = relax_inner(ef, eh, frows)
        new_ef = torch.cat([f0.reshape(1), frows[:-1, -1]])
        new_eh = torch.cat([h0.reshape(1), houts[:-1]])
        close = torch.all((new_ef - ef).abs()
                          <= 1e-6 * torch.clamp(ef.abs(), min=1e-3))
        stable = close & torch.all(new_eh == eh)
        ef, eh = new_ef, new_eh
        if bool(stable):                           # the one sync a round
            break
    f_all = frows.reshape(-1)[:n]
    return (f_all * x, f_all[n - 1].clone(), houts[-1].clone(),
            stable & conv if check else None)
