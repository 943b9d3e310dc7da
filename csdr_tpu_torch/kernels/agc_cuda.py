"""agc_ff on the card: the chunked AGC's waveform relaxation (the
counterpart of csdr_tpu's two ``jax.lax.while_loop``s in
csdr_tpu/ops/agc.py:385, 437) and the exact per-sample recurrence (the
counterpart of its ``lax.scan`` at :171); no Pallas kernel there.

csdr_tpu compiles both relaxation loops, the inner one over the branch
masks and the outer one over the chunk boundaries, into one device
program.  In eager torch they were Python loops of small ops and a host
sync a round (~2 900 launches a chunk of the SSB and AM receivers' audio),
so they are hand-written CUDA, ``csrc/agc.cu``: one cooperative launch a
call, a chunk row over a cluster of CTAs, bit for bit :func:`relax_plain`.
:func:`cluster_plan` picks the cluster size from the row count;
:func:`scan_cycles` measures on the card the chain of one affine scan of an
8192-sample row, which bounds the function.

:func:`relax` takes a 1-D stream and agc_ff's constants (``agc_ff_chunked``
is the entry point) and returns (y, next_gain, next_hang, converged); on
the card every output stays there, with no host sync and no scalar
upload.  The kernel takes a ``chunk`` of at most ``MAX_CHUNK`` samples
(a CTA's slice of it, 20 B a sample, lives in shared memory); a larger
one raises.  With more rows than clusters fit on the card at once
(:func:`resident_rows`), each cluster runs its rows in turns.

The exact recurrence (any attack wait time) is ``csrc/agc_exact.cu``:
:func:`scan` runs it over a 1-D float32 stream from a state of four
one-element tensors (gain, hang, peak, attack-wait count) on the stream's
device, one warp a call with one thread carrying the recurrence, bit for
bit :func:`scan_plain`, the numpy float32 loop on the host.  On the card
it is one launch, with no host sync and no scalar upload.
:func:`exact_cycles` measures the recurrence's chain, which bounds it.

The wrappers launch their kernels for CUDA tensors, or raise; they take
the plain versions only for CPU tensors.  ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core.scan import affine_scan
from csdr_tpu_torch.kernels import _build

LAUNCHES = {"agc_relax": 0, "agc_ff_scan": 0}
MAX_CHUNK = 8192        # samples a row the kernel takes
MAX_SLICE = 2048        # samples a CTA of the relaxation kernel holds
CLUSTER_SIZES = (16, 8, 4, 2, 1)   # CTAs a row the kernel takes
CLUSTER_MAX = 16        # the most cluster_plan gives (16 is non-portable:
                        # the H100 takes it, and it beat 8 on E's and F's
                        # six rows, PERF.md)
PROBE_MAX = 4096        # samples the exact scan's probe stages
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
    return _relax_cuda(x, reference, attack_rate, decay_rate, max_gain,
                       int(hang_time), gain_filter_alpha, last_gain,
                       last_hang, started, chunk, iters, check, rounds)


def _relax_cuda(x, reference, attack_rate, decay_rate, max_gain, hang_time,
                gain_filter_alpha, last_gain, last_hang, started, chunk,
                iters, check, rounds, smids=None):
    """One launch of the relaxation kernel on a nonempty 1-D float32 CUDA
    stream ``x`` (``chunk`` a multiple of 128); ``smids`` (int32, rows x
    the cluster size), if given, gets each CTA's SM."""
    dev, n = x.device, x.shape[0]
    f0, f0_val = _entry(last_gain, torch.float32, dev)
    h0, h0_val = _entry(last_hang, torch.int32, dev)
    rows = -(-n // chunk)
    k, spread = cluster_plan(rows, chunk, lambda k, s: _fits(dev, chunk, k,
                                                             s))
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
        x.data_ptr(), n, chunk, iters, hang_time, int(bool(started)),
        np.float32(reference), np.float32(attack_rate),
        np.float32(decay_rate), np.float32(max_gain),
        np.float32(1.0 - gain_filter_alpha),
        None if f0 is None else f0.data_ptr(), f0_val,
        None if h0 is None else h0.data_ptr(), h0_val, k, int(spread),
        _fits(dev, chunk, k, spread), y.data_ptr(), gain.data_ptr(), hang.data_ptr(), conv.data_ptr(),
        table.data_ptr() if rounds else None, traj.data_ptr(),
        xstate.data_ptr(), None if smids is None else smids.data_ptr(),
        stream)
    _build.check(code, "agc_relax")
    LAUNCHES["agc_relax"] += 1
    return (y, gain, hang, conv if check else None) + (
        (table,) if rounds else ())


def cluster_sizes(chunk: int) -> list:
    """The cluster sizes the relaxation kernel takes for a chunk (a
    multiple of 128), largest first: each CTA a slice of a multiple of 128
    samples, at most MAX_SLICE, a power of two when the row has more than
    one (a scan step's pushed partners then come from one earlier slice),
    and at most CLUSTER_MAX CTAs."""
    return [k for k in CLUSTER_SIZES if k <= CLUSTER_MAX
            and chunk % (128 * k) == 0 and chunk // k <= MAX_SLICE
            and (k == 1 or (chunk // k) & (chunk // k - 1) == 0)]


def cluster_plan(rows: int, chunk: int, fits):
    """(K, spread): the CTAs a row and whether each takes an SM of its own,
    for ``rows`` rows of ``chunk`` samples; ``fits(K, spread)`` gives the
    clusters the card holds at once.  The rows all resident if they can
    be, one CTA an SM before CTAs sharing SMs, the largest K first (the
    shortest chain a row); else in turns, the fewest turns, then the
    smallest K (the least exchange between SMs for the same work)."""
    ks = [k for k in cluster_sizes(chunk) if fits(k, False) > 0]
    if not ks:
        raise RuntimeError(f"agc relax: no cluster fits at chunk {chunk}")
    for spread in (True, False):
        for k in ks:
            if rows <= fits(k, spread):
                return k, spread
    return min(ks, key=lambda k: (-(-rows // fits(k, False)), k)), False


_FITS: dict = {}


def _fits(dev, chunk: int, k: int, spread: bool) -> int:
    """Clusters of ``k`` CTAs the kernel fits on card ``dev`` at once
    (asked once for each chunk, size and layout)."""
    key = (dev.index, chunk, k, bool(spread))
    if key not in _FITS:
        with torch.cuda.device(dev):
            _FITS[key] = _build.lib().csdr_agc_relax_clusters(
                chunk, k, int(bool(spread)))
    return _FITS[key]


def plan(n: int, chunk: int = 8192, device="cuda") -> dict:
    """How :func:`relax` lays ``n`` samples in rows of ``chunk`` over the
    current card: the cluster size and layout, the CTAs launched, their
    threads and the clusters resident at once."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("agc relax plan: a CUDA device only")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    chunk = -(-chunk // 128) * 128
    rows = -(-n // chunk)
    k, spread = cluster_plan(rows, chunk, lambda k, s: _fits(dev, chunk, k,
                                                             s))
    fit = _fits(dev, chunk, k, spread)
    return {"size": k, "spread": spread, "rows": rows,
            "ctas": min(rows, fit) * k,
            "threads": _build.lib().csdr_agc_relax_threads(chunk, k,
                                                           int(spread)),
            "resident_clusters": fit}


def sms_used(x: torch.Tensor, **kw) -> int:
    """The SMs that one launch of the relaxation kernel on ``x`` (a 1-D
    CUDA stream, :func:`relax`'s keywords) ran its CTAs on, read from
    each CTA's %smid.  The launch is counted in ``LAUNCHES``."""
    if not x.is_cuda or x.dim() != 1 or x.shape[0] == 0:
        raise ValueError("agc relax sms_used: a nonempty 1-D CUDA stream")
    args = dict(reference=0.2, attack_rate=0.01, decay_rate=0.0001,
                max_gain=65536.0, hang_time=200, gain_filter_alpha=0.999,
                last_gain=1.0, last_hang=0, started=False, chunk=8192,
                iters=14)
    args.update(kw)
    args["chunk"] = -(-args["chunk"] // 128) * 128
    args["hang_time"] = int(args["hang_time"])
    p = plan(x.shape[0], args["chunk"], x.device)
    smids = torch.full((p["rows"] * p["size"],), -1, dtype=torch.int32,
                       device=x.device)
    _relax_cuda(x.float().contiguous(), check=True, rounds=False,
                smids=smids, **args)
    got = smids[: p["ctas"]].cpu()
    if bool((got < 0).any()):
        raise RuntimeError("agc relax sms_used: a CTA left no SM")
    return len(set(got.tolist()))


def resident_rows(chunk: int = 8192) -> int:
    """Rows of ``chunk`` samples the kernel runs at once on the current
    card: the most clusters of any size it takes there (one row each)."""
    chunk = -(-chunk // 128) * 128
    dev = torch.device("cuda", torch.cuda.current_device())
    got = max((_fits(dev, chunk, k, False) for k in cluster_sizes(chunk)),
              default=0)
    if got < 1:
        raise RuntimeError(f"agc relax: no resident clusters at chunk "
                           f"{chunk}")
    return got


def scan_cycles(scans: int, device="cuda") -> float:
    """SM cycles of the chain of one affine scan of an 8192-sample row
    (``csrc/agc.cu``'s probe: 13 dependent Hillis-Steele steps on one warp,
    each a store to shared memory, a warp barrier, the partner's load and
    the add's product and sum), over ``scans`` scans after a first pass.
    It relaxes nothing and is not counted in ``LAUNCHES``."""
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    if not cycles.is_cuda:
        raise ValueError("agc scan probe: runs on a CUDA device only")
    sink = torch.empty(32, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(cycles.device).cuda_stream
    _build.check(_build.lib().csdr_agc_chain_probe(
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


# ---------------------------------------------------------------------------
# the exact recurrence (csrc/agc_exact.cu) and its plain version, the loop
# on the host
# ---------------------------------------------------------------------------

_STATE = (("gain", torch.float32), ("hang", torch.int32),
          ("peak", torch.float32), ("awc", torch.int32))


def _int32(v, name: str) -> int:
    if int(v) != v or not -(1 << 31) <= int(v) < (1 << 31):
        raise ValueError(f"agc_ff scan: {name} {v} is not an int32")
    return int(v)


def scan(x: torch.Tensor, gain, hang, peak, awc, started=False,
         reference=0.2, attack_rate=0.01, decay_rate=0.0001,
         max_gain=65536.0, hang_time=200, attack_wait_time=0,
         gain_filter_alpha=0.999):
    """agc_ff's exact recurrence over ``x`` from the state (gain, hang,
    peak, awc); ``started`` False skips sample 0 (the stream's start).
    Returns (y, gain, hang, peak, awc), the state as 0-dim tensors.

    CUDA tensors launch the kernel: ``x`` 1-D float32 and the state four
    one-element tensors on its device (float32, int32, float32, int32),
    nothing read back and nothing uploaded.  CPU tensors take
    :func:`scan_plain`; anything else raises."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"agc_ff scan: runs on CPU or CUDA tensors, "
                             f"not {x.device}")
        return scan_plain(x, gain, hang, peak, awc, started, reference,
                          attack_rate, decay_rate, max_gain, hang_time,
                          attack_wait_time, gain_filter_alpha)
    if x.dim() != 1:
        raise TypeError(f"agc_ff scan: want a 1-D stream, got "
                        f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"agc_ff scan: want float32 samples, got {x.dtype}")
    state = []
    for (name, dtype), v in zip(_STATE, (gain, hang, peak, awc)):
        if not isinstance(v, torch.Tensor) or v.numel() != 1:
            raise TypeError(f"agc_ff scan: the {name} state is one element "
                            f"of a tensor on the card")
        if v.device != x.device:
            raise ValueError(f"agc_ff scan: the {name} state on {v.device}, "
                             f"the stream on {x.device}")
        if v.dtype != dtype:
            raise TypeError(f"agc_ff scan: the {name} state is {v.dtype}, "
                            f"not {dtype}")
        state.append(v.reshape(()))
    hang_time = _int32(hang_time, "hang_time")
    wait = _int32(attack_wait_time, "attack_wait_time")
    if x.shape[0] == 0:
        return (x, *state)
    x = x.contiguous()
    dev = x.device
    y = torch.empty_like(x)
    out = [torch.empty((), dtype=dtype, device=dev) for _, dtype in _STATE]
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.lib().csdr_agc_ff_scan(
        x.data_ptr(), x.shape[0], int(bool(started)), np.float32(reference),
        np.float32(attack_rate), np.float32(decay_rate),
        np.float32(max_gain), np.float32(gain_filter_alpha), hang_time, wait,
        *(t.data_ptr() for t in state), y.data_ptr(),
        *(t.data_ptr() for t in out), stream)
    _build.check(code, "agc_ff_scan")
    LAUNCHES["agc_ff_scan"] += 1
    return (y, *out)


def exact_cycles(x: torch.Tensor, gain=1.0, hang=0, peak=None, awc=0,
                 reference=0.2, attack_rate=0.01, decay_rate=0.0001,
                 max_gain=65536.0, hang_time=200, attack_wait_time=0,
                 gain_filter_alpha=0.999) -> float:
    """SM cycles a sample of agc_ff's shortest chain on the card
    (``csrc/agc_exact.cu``'s probe): over ``x`` (at most PROBE_MAX
    samples on the card) from the state given as numbers, one thread runs
    the kernel's step, recording what it decides beside its chain (the
    rate, whether the gain moves), then the chain alone from shared
    memory, timed.  Raises if the chain's last gain is not the step's bit
    for bit.  It is not counted in ``LAUNCHES``."""
    if not x.is_cuda:
        raise ValueError("agc_ff scan probe: runs on a CUDA device only")
    if x.dim() != 1 or x.dtype != torch.float32 \
            or not 0 < x.shape[0] <= PROBE_MAX:
        raise ValueError(f"agc_ff scan probe: want 1 to {PROBE_MAX} float32 "
                         f"samples, got {tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    g = np.float32(gain)
    pk = np.float32(float(reference) / float(g)) if peak is None \
        else np.float32(peak)
    cycles = torch.zeros(1, dtype=torch.int64, device=x.device)
    sink = torch.zeros(2, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(_build.lib().csdr_agc_ff_chain_probe(
        cycles.data_ptr(), x.data_ptr(), x.shape[0], np.float32(reference),
        np.float32(attack_rate), np.float32(decay_rate),
        np.float32(max_gain), np.float32(gain_filter_alpha),
        _int32(hang_time, "hang_time"),
        _int32(attack_wait_time, "attack_wait_time"), g, int(hang), pk,
        int(awc), sink.data_ptr(), stream), "agc_ff scan probe")
    if float(sink[1]) != 1.0:
        raise RuntimeError("agc_ff scan probe: the chain's last gain is not "
                           "the step's")
    return int(cycles.item()) / x.shape[0]


def _host(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def scan_plain(x: torch.Tensor, gain, hang, peak, awc, started=False,
               reference=0.2, attack_rate=0.01, decay_rate=0.0001,
               max_gain=65536.0, hang_time=200, attack_wait_time=0,
               gain_filter_alpha=0.999):
    """:func:`scan` one sample at a time in numpy float32 on the host (the
    reference libcsdr_gpl.c:163-260); the state may be numbers or tensors.
    Returns CPU tensors."""
    f32 = np.float32
    xs = x.detach().float().cpu().numpy()
    ref, ar, dr = f32(reference), f32(attack_rate), f32(decay_rate)
    mg, alpha, zero = f32(max_gain), f32(gain_filter_alpha), f32(0.0)
    g, pk = f32(_host(gain)), f32(_host(peak))
    hang, awc = int(_host(hang)), int(_host(awc))
    y = np.empty_like(xs)
    with np.errstate(all="ignore"):       # ref/|x| -> inf is the reference's
        for i, xi in enumerate(xs):
            if i == 0 and not bool(started):
                y[0] = g * xi
                continue
            gain = g
            if xi != 0:
                input_abs = abs(xi)
                error = ref / input_abs - g
                if error < 0:                       # louder: attack
                    if pk < input_abs:
                        pk, awc = input_abs, attack_wait_time
                    if awc > 0:
                        awc -= 1
                    else:
                        gain = g + error * ar
                        hang = hang_time
                elif hang > 0:                      # quieter, hanging
                    hang -= 1
                else:                               # quieter: decay
                    gain = g + error * dr
            gain = min(max(gain, zero), mg)
            g = gain + g - alpha * g
            y[i] = g * xi
    return (torch.from_numpy(y), torch.tensor(g, dtype=torch.float32),
            torch.tensor(hang, dtype=torch.int32),
            torch.tensor(pk, dtype=torch.float32),
            torch.tensor(awc, dtype=torch.int32))
