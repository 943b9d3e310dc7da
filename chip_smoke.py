#!/usr/bin/env python3
"""Smoke run of csdr_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csdr_tpu_torch/csrc (nvcc, at first use), then
prints one JSON line per phase and exits non-zero at the first failure:

1. env: the card, its power limit, the CUDA and nvcc versions, build time.
2. kernels: each kernel against its plain PyTorch version on the same
   inputs on the card (SNR bar stated per entry), with its time, the plain
   version's, a one-call library yardstick (TF32 off) and the least time
   the card could take (bytes or FP32 operations over the peak rates):
   the FIR pair (K1, K2), K2 also at path C's D=50/T=801, the
   kernel-order FFT pair (K3) at the shapes of paths B and C, the fastddc
   inverse (K4) at path A's shape and at the D=4 and D=256 plans.
3. path: wfm_advanced over 10 s of an FM-modulated 1 kHz tone at 2.4 Msps
   in 2.4 M-sample chunks, through run_offline on the card: the tone comes
   back, each chunk launched the fused kernel once, and the first 2 chunks
   match the same pipeline on the CPU.  Then the unfused chain
   (fuse_shift=False), which runs the plain FIR kernel.
4. throughput: wfm_advanced's Msps on the card, per chunk and per block.
5. path A/A'/B/C, each driven with every launch count zeroed just before
   and read just after:
   A  the 64-channel fastddc channelizer at D=16, 10 chunks of 1024
      frames: K4 once per chunk, test tones come out at delta*D, the first
      chunk equals the CPU per channel, also with TF32 switched on
      globally (the blocks' own products stay in full float32);
   A' fastddc_fwd_block | fastddc_inv_block at D=16, 3 chunks: K4 once
      per chunk, equal to A;
   B  fwd (kernel order) | classed inverse at D=50, 64 channels, 3 chunks
      of 3200 frames: K3 forward once per chunk, tones at delta*D, card
      equals CPU on one chunk;
   C  ssb_receiver(agc_on=False) over 10 s of a USB tone at 2.4 Msps: K2,
      K3 forward and K3 inverse once per chunk, the tone at its frequency,
      an out-of-band tone rejected, card equals CPU on 2 chunks.
   Matrix products outside the kernels must run with TF32 off.
6. throughput of A, B and C as for WFM.

A card-vs-CPU check that fails first re-runs both sides once, then writes
what it saw (the input, both outputs and the re-runs in the worst channel,
per-channel SNRs, the worst frame) to chiprun_out/mismatch_<path>.npz
beside this script, and exits non-zero.

The second-last lines are the kernel table as one JSON object and the
card's name and power limit as nvidia-smi gives them; the last line is the
result object.  Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FS = 2_400_000             # one RTL-SDR stream, 2.4 Msps
CHUNK = 2_400_000          # one second per chunk, as bench.py runs it
SECONDS = 10
SHIFT = -0.2               # the carrier sits at +0.2*FS
SNR_BAR = 110.0            # kernel vs plain, dB
AUDIO_BAR = 60.0           # card vs CPU audio, dB (tests/test_torch_wfm.py)
HBM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
FP32_FLOPS = 67e12         # H100 SXM FP32 outside the tensor cores
KERNEL_SOURCE = "csdr_tpu_torch/csrc/fir_decimate.cu"
FFT_SOURCE = "csdr_tpu_torch/csrc/fft_ko.cu"
INV_SOURCE = "csdr_tpu_torch/csrc/fastddc_inv.cu"
CHANNELS = 64              # BASELINE config 5's channelizer
FRAMES_A = 1024            # bench.py fastddc16: frames per chunk
FRAMES_B = 3200            # bench.py fastddc50
CHUNKS_A, CHUNKS_AP, CHUNKS_B, CHUNKS_C = 10, 3, 3, 10
CHUNK_C = 270 * 8900       # ~1 s at 2.4 Msps, 270 bandpass frames
CHANNEL_BAR = 100.0        # card vs CPU, dB, per channel (fastddc)
SSB_BAR = 110.0            # card vs CPU audio, dB (K2 and K3 in f32 FMA)
MISMATCH_DIR = Path(__file__).resolve().parent / "chiprun_out"


class SmokeFailure(RuntimeError):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def require_no_tf32(torch) -> None:
    """The timed library yardsticks and the paths run with cuBLAS's TF32
    flag off, PyTorch's default (the float32 matmul precision "highest"
    sets the same flag)."""
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    err = float(np.sum(np.abs(ref - test) ** 2))
    if err == 0.0:
        return float("inf")
    return float(10 * np.log10(np.sum(np.abs(ref) ** 2) / err))


def channel_snrs(ref, test) -> np.ndarray:
    """SNR per row of 2-D outputs (channels), or one SNR for 1-D audio."""
    ref, test = np.atleast_2d(ref), np.atleast_2d(test)
    return np.asarray([snr_db(ref[k], test[k]) for k in range(len(ref))])


def require_match(what: str, card, cpu, bar: float, x=None, rerun_card=None,
                  rerun_cpu=None, frame: int = 1) -> float:
    """The least SNR of ``card`` against ``cpu`` (per channel for 2-D
    outputs), which must reach ``bar``.  Otherwise both sides run once
    more, and what the check saw goes to chiprun_out/ before it fails:
    the input ``x``, the worst channel of each output and re-run, the SNRs
    per channel and the error per ``frame`` samples of the worst one."""
    card, cpu = np.atleast_2d(card), np.atleast_2d(cpu)
    snrs = channel_snrs(cpu, card)
    if snrs.min() >= bar:
        return float(snrs.min())
    worst = int(np.argmin(snrs))
    card2 = None if rerun_card is None else np.atleast_2d(rerun_card())
    cpu2 = None if rerun_cpu is None else np.atleast_2d(rerun_cpu())
    err = np.abs(card[worst] - cpu[worst]) ** 2
    per_frame = err[: len(err) // frame * frame].reshape(-1, frame).sum(1)
    summary = {"what": what, "bar_db": bar, "worst_channel": worst,
               "worst_frame": int(np.argmax(per_frame)), "frame": frame,
               "worst_sample": int(np.argmax(err)),
               "min_snr_db": float(snrs.min()),
               "channels_under_bar": int(np.sum(snrs < bar))}
    arrays = {"snr_card_vs_cpu": snrs, "err_per_frame": per_frame,
              "card_worst": card[worst], "cpu_worst": cpu[worst]}
    if card2 is not None:
        arrays["card_rerun_worst"] = card2[worst]
        summary["card_rerun_vs_card_db"] = float(channel_snrs(card, card2).min())
        summary["card_rerun_vs_cpu_db"] = float(channel_snrs(cpu, card2).min())
    if cpu2 is not None:
        arrays["cpu_rerun_worst"] = cpu2[worst]
        summary["cpu_rerun_vs_cpu_db"] = float(channel_snrs(cpu, cpu2).min())
    if x is not None:
        arrays["x"] = np.asarray(x)
    MISMATCH_DIR.mkdir(exist_ok=True)
    path = MISMATCH_DIR / f"mismatch_{what.split(':')[0].replace(' ', '_')}.npz"
    np.savez_compressed(path, summary=json.dumps(summary), **arrays)
    emit("mismatch", saved=str(path.relative_to(MISMATCH_DIR.parent)),
         **summary)
    raise SmokeFailure(f"{what}: {snrs.min():.1f} dB < {bar} dB")


def fm_tone(n: int, fs: float = FS, carrier: float = -SHIFT) -> np.ndarray:
    """The verify skill's FM-modulated 1 kHz tone (75 kHz deviation) on a
    carrier at ``carrier``*fs."""
    t = np.arange(n) / fs
    audio = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    phase = 2 * np.pi * (np.cumsum(audio) * 75_000.0 / fs
                         + np.mod(carrier * np.arange(n), 1.0))
    return np.exp(1j * phase).astype(np.complex64)


def tone_hz(audio: np.ndarray, rate: int = 48_000) -> float:
    seg = audio[2000:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    return float(np.argmax(spec) * rate / len(seg))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_env(torch, build):
    smi = nvidia_smi_line()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    t0 = time.perf_counter()
    lib = build.lib()
    load_s = time.perf_counter() - t0
    from csdr_tpu_torch.kernels import fastddc_cuda, fir_cuda
    require(lib.csdr_fir_decimate_tile() == fir_cuda.TILE,
            "kernel tile differs from fir_cuda.TILE")
    require(lib.csdr_fastddc_inv_smem_bytes() == fastddc_cuda.SMEM_BYTES,
            "fastddc_inv tiles differ from fastddc_cuda's")
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc.stdout.strip().splitlines()[-1],
         build_s=build.build_seconds, build_and_load_s=load_s,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32)
    return smi


def kernel_case(torch, name, d, t, kout, rate, theta, seed):
    """One kernel at one shape against its plain version; timings."""
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.kernels import fir_cuda
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    tail_len = ((t - 1 + d - 1) // d) * d
    n = kout * d
    gen = torch.Generator(device=dev).manual_seed(seed)
    # four input sets (~80 MB at the WFM shape) cycled by the timed loops,
    # so a launch does not find its input in the 50 MB L2
    sets = [(torch.randn(tail_len, dtype=torch.complex64, device=dev,
                         generator=gen),
             torch.randn(n, dtype=torch.complex64, device=dev,
                         generator=gen)) for _ in range(4)]
    taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
    mix = name == "shift_fir_decimate"
    phase = (rate, theta) if mix else ()
    kern = getattr(fir_cuda, name)
    plain = getattr(fir_cuda, name + "_plain")

    tail, x = sets[0]
    y_kernel = kern(tail, x, taps, d, kout, *phase)
    y_plain = plain(tail, x, taps, d, kout, *phase)
    torch.cuda.synchronize()
    yk, yp = y_kernel.cpu().numpy(), y_plain.cpu().numpy()
    snr = snr_db(yp, yk)
    max_abs_err = float(np.max(np.abs(yk - yp)))
    require(np.all(np.isfinite(yk)), f"{name}: non-finite output")
    require(snr > SNR_BAR, f"{name} D={d} T={t}: SNR {snr:.1f} dB vs plain "
                           f"<= {SNR_BAR}")

    it = iter(range(1 << 30))

    def pick():
        return sets[next(it) % len(sets)]

    kernel_ms = time_cuda(lambda: kern(*pick(), taps, d, kout, *phase),
                          iters=40, queue_ahead_ms=20.0)
    plain_ms = time_cuda(lambda: plain(*pick(), taps, d, kout, *phase),
                         iters=3, warmup=1, repeats=3)
    # library yardstick: one conv1d (cuDNN, TF32 off) over [tail|x] as
    # (re, im) planes, pre-mixed for the shifted kernel; never used by
    # the port
    planes = []
    for tl, xx in sets:
        v = torch.cat([tl, xx])
        if mix:
            v = v * fir_cuda.nco_phasor(v.shape[0], rate, theta, dev)
        planes.append(torch.view_as_real(v).T.contiguous()[:, None, :])
    w = taps.view(1, 1, -1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y_lib = torch.nn.functional.conv1d(planes[0], w, stride=d)
        lib_snr = snr_db(yp, torch.complex(y_lib[0, 0, :kout],
                                           y_lib[1, 0, :kout]).cpu().numpy())
        lib_ms = time_cuda(
            lambda: torch.nn.functional.conv1d(planes[next(it) % 4], w,
                                               stride=d),
            iters=40, queue_ahead_ms=20.0)
    # least time: each input read once, each output written once; FP32
    # operations: 2 FMA (4 flops) per tap per output, 6 per mixed sample
    nbytes = 8 * (tail_len + n) + 4 * t + 8 * kout
    flops = 4 * t * kout + (6 * (tail_len + n) if mix else 0)
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return {
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": ("csdr_tpu/kernels/fir_pallas.py:226" if mix
                     else "csdr_tpu/kernels/fir_pallas.py:211"),
        "shape": {"D": d, "T": t, "kout": kout, "n": n},
        "snr_db": snr, "snr_bar_db": SNR_BAR, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
        "library_call": "torch.nn.functional.conv1d(stride=D), cuDNN, "
                        "TF32 off" + (", on the pre-mixed stream" if mix
                                      else ""),
        "library_snr_db": lib_snr,
        "bytes": nbytes, "flops": flops,
    }


def phase_kernels(torch):
    kout = CHUNK // 10
    cases = [dict(kernel_case(torch, "shift_fir_decimate", 10, 79, kout,
                              SHIFT, 0.3, 1), path="wfm"),
             dict(kernel_case(torch, "fir_decimate", 10, 79, kout, 0.0, 0.0,
                              2), path="wfm_unfused")]
    # the BASELINE headline op fir_decimate_cc: D=10, T=1023
    headline = kernel_case(torch, "fir_decimate", 10, 1023, 262_144, 0.0,
                           0.0, 3)
    for c in cases + [headline]:
        emit("kernels", **c)
    emit("kernels", ported=[
        {"kernel": "K1 _fir_vmem_shift_kernel", "status": "ported",
         "wrapper": "csdr_tpu_torch.kernels.fir_cuda.shift_fir_decimate"},
        {"kernel": "K2 _fir_vmem_kernel", "status": "ported",
         "wrapper": "csdr_tpu_torch.kernels.fir_cuda.fir_decimate"},
        {"kernel": "K3 _fft_fwd_kernel/_fft_inv_kernel", "status": "ported",
         "wrapper": "csdr_tpu_torch.kernels.fft_cuda.fft_ko / ifft_ko"},
        {"kernel": "K4 fastddc _inv_kernel", "status": "ported",
         "wrapper": "csdr_tpu_torch.kernels.fastddc_cuda.fastddc_inv"},
        {"kernel": "K5 _fir_poly_kernel", "status": "queued"}])
    return cases, headline


def _timed_sets(make, nsets=4):
    """``nsets`` input sets and a picker that cycles them, so a timed loop
    does not find its input in the 50 MB L2 where the sets exceed it."""
    sets = [make(i) for i in range(nsets)]
    it = iter(range(1 << 30))
    return sets, lambda: sets[next(it) % nsets]


def fft_case(torch, name, n, b, seed):
    """K3 (fft_ko or ifft_ko) at (N, B) against its plain version."""
    from csdr_tpu_torch.kernels import fft_cuda
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    sets, pick = _timed_sets(lambda i: torch.randn(
        b, n, dtype=torch.complex64, device=dev, generator=gen))
    kern = getattr(fft_cuda, name)
    plain = getattr(fft_cuda, name + "_plain")
    yk, yp = kern(sets[0]), plain(sets[0])
    torch.cuda.synchronize()
    yk, yp = yk.cpu().numpy(), yp.cpu().numpy()
    snr = snr_db(yp, yk)
    require(np.all(np.isfinite(yk)), f"{name}: non-finite output")
    require(snr > SNR_BAR, f"{name} N={n} B={b}: SNR {snr:.1f} dB vs plain "
                           f"<= {SNR_BAR}")
    inverse = name == "ifft_ko"
    ms = time_cuda(lambda: kern(pick()), iters=40, queue_ahead_ms=20.0)
    plain_ms = time_cuda(lambda: plain(pick()), iters=20, queue_ahead_ms=20.0)
    if inverse:
        def lib():
            return torch.fft.ifft(pick(), norm="forward")
    else:
        def lib():
            return torch.fft.fft(pick())
    lib_ms = time_cuda(lib, iters=40, queue_ahead_ms=20.0)
    # least time: each point read once and written once (16 B); operations:
    # 5 N log2 N per radix-2 transform
    nbytes = 16 * b * n
    flops = 5 * b * n * int(np.log2(n))
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return {
        "name": name, "route": "cuda", "source": FFT_SOURCE,
        "replaces": ("csdr_tpu/kernels/fft_pallas.py:265" if inverse
                     else "csdr_tpu/kernels/fft_pallas.py:220"),
        "shape": {"N": n, "B": b},
        "snr_db": snr, "snr_bar_db": SNR_BAR,
        "max_abs_err": float(np.max(np.abs(yk - yp))),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
        "library_call": ("torch.fft.ifft(norm='forward')" if inverse
                         else "torch.fft.fft") + " on (B, N) complex64 in "
                        "natural order (cuFFT); the kernel-order gather is "
                        "not in it",
        "bytes": nbytes, "flops": flops,
    }


def inv_case(torch, d, b, rates, seed):
    """K4 at one plan, C = len(rates) channels, B frames, against its plain
    version; the yardstick is the same linear map as one complex64 matmul
    of the spectra by the fused (fft, C*M) matrix (TF32 off)."""
    from csdr_tpu_torch.kernels import fastddc_cuda
    from csdr_tpu_torch.ops import fastddc as fd
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    ddc = fd.fastddc_init(0.05, d)
    tq, w, dd, cyc = fd.channel_factored2_arrays(ddc, rates)
    c, pre, inv = tq.shape
    m = w.shape[1]
    rot = np.exp(2j * np.pi * np.mod(np.arange(b)[None, :] * cyc[:, None],
                                     1.0)).astype(np.complex64)
    mats = [torch.from_numpy(a).to(dev) for a in (tq, w, dd, rot)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    sets, pick = _timed_sets(lambda i: torch.randn(
        b, ddc.fft_size, dtype=torch.complex64, device=dev, generator=gen))
    yk = fastddc_cuda.fastddc_inv(sets[0], *mats, m)
    yp = fastddc_cuda.fastddc_inv_plain(sets[0], *mats, m)
    torch.cuda.synchronize()
    yk, yp = yk.cpu().numpy(), yp.cpu().numpy()
    snr = snr_db(yp, yk)
    require(np.all(np.isfinite(yk)), "fastddc_inv: non-finite output")
    require(snr > SNR_BAR, f"fastddc_inv D={d}: SNR {snr:.1f} dB vs plain "
                           f"<= {SNR_BAR}")
    ms = time_cuda(lambda: fastddc_cuda.fastddc_inv(pick(), *mats, m),
                   iters=40, queue_ahead_ms=20.0)
    plain_ms = time_cuda(
        lambda: fastddc_cuda.fastddc_inv_plain(pick(), *mats, m),
        iters=20, queue_ahead_ms=20.0)
    g = torch.from_numpy(np.concatenate(
        [fd.channel_fused_matrix(ddc, r)[0] for r in rates], 1)).to(dev)
    require_no_tf32(torch)
    z = torch.matmul(sets[0], g).reshape(b, c, m).permute(1, 0, 2)
    lib_snr = snr_db(yp, (z * mats[3][:, :, None]).cpu().numpy())
    lib_ms = time_cuda(lambda: torch.matmul(pick(), g), iters=40,
                       queue_ahead_ms=20.0)
    # least time: S, TQ, W, d, rot read once, out written once; FP32
    # operations: 8 per complex MAC of the fold and of the iDFT
    nbytes = 8 * (b * pre * inv + c * pre * inv + inv * m + c * m + c * b
                  + c * b * m)
    flops = 8 * b * c * pre * inv + 8 * b * c * inv * m
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return {
        "name": "fastddc_inv", "route": "cuda", "source": INV_SOURCE,
        "replaces": "csdr_tpu/kernels/fastddc_pallas.py:54",
        "shape": {"D": d, "B": b, "C": c, "pre": pre, "inv": inv, "M": m},
        "snr_db": snr, "snr_bar_db": SNR_BAR,
        "max_abs_err": float(np.max(np.abs(yk - yp))),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
        "library_call": "torch.matmul(spectra (B, fft), fused G (fft, C*M)) "
                        "complex64, TF32 off: the same map before the "
                        "per-frame NCO",
        "library_snr_db": lib_snr,
        "bytes": nbytes, "flops": flops,
    }


def bench_rates():
    """64 channel shifts in [-0.4, 0.4), drawn as bench.py draws them."""
    return np.random.default_rng(0).uniform(-0.4, 0.4, CHANNELS)


def phase_fastddc_kernels(torch):
    """K2, K3 and K4 at the shapes paths A, B and C give them, each tagged
    with its path; K4 also at the D=4 and D=256 plans, on no path."""
    rates = bench_rates()
    frames_c = CHUNK_C // 8900             # bandpass frames of N=256
    cases = [
        dict(fft_case(torch, "fft_ko", 1024, FRAMES_B, 11), path="B"),
        dict(kernel_case(torch, "fir_decimate", 50, 801, CHUNK_C // 50, 0.0,
                         0.0, 16), path="C"),
        dict(fft_case(torch, "fft_ko", 256, frames_c, 17), path="C"),
        dict(fft_case(torch, "ifft_ko", 256, frames_c, 12), path="C"),
        dict(inv_case(torch, 16, FRAMES_A, rates, 13), path="A")]
    others = [inv_case(torch, d, FRAMES_A, rates, 14 + d) for d in (4, 256)]
    for c in cases + others:
        emit("kernels", **c)
    return cases


def drive_path(torch, pipe, x, name):
    """run_offline on the card with the launch counts zeroed just before
    and read just after."""
    from csdr_tpu_torch import run_offline
    from csdr_tpu_torch.kernels import fir_cuda

    fir_cuda.reset_launches()
    t0 = time.perf_counter()
    audio = run_offline(pipe, x, block_size=CHUNK)
    wall = time.perf_counter() - t0
    launches = dict(fir_cuda.LAUNCHES)
    hz = tone_hz(audio)
    require(np.all(np.isfinite(audio)) and audio.dtype == np.float32,
            f"{name}: audio not finite float32")
    require(abs(hz - 1000.0) < 5.0, f"{name}: tone at {hz} Hz, not 1 kHz")
    return audio, launches, hz, wall


def phase_path(torch):
    from csdr_tpu_torch import run_offline
    from csdr_tpu_torch.models import wfm

    x = fm_tone(SECONDS * FS)
    chunks = len(x) // CHUNK
    audio, launches, hz, wall = drive_path(
        torch, wfm.wfm_advanced(shift_rate=SHIFT), x, "wfm_advanced")
    require(launches == {"shift_fir_decimate": chunks, "fir_decimate": 0},
            f"launches {launches} for {chunks} chunks")
    def wfm_on(device):
        return run_offline(wfm.wfm_advanced(shift_rate=SHIFT), x[:2 * CHUNK],
                           block_size=CHUNK, device=device)

    cpu = wfm_on("cpu")
    cpu_snr = require_match("wfm_advanced: card vs CPU audio",
                            audio[: len(cpu)], cpu, AUDIO_BAR,
                            x[:2 * CHUNK], lambda: wfm_on("cuda"),
                            lambda: wfm_on("cpu"), frame=4800)
    require(np.allclose(audio[: len(cpu)], cpu, rtol=2e-3, atol=5e-4),
            f"card vs CPU audio: not allclose at {cpu_snr:.1f} dB")
    emit("path", pipeline="wfm_advanced(shift_rate=-0.2)", chunks=chunks,
         chunk=CHUNK, audio_samples=len(audio), tone_hz=hz,
         launches=launches, card_vs_cpu_snr_db=cpu_snr,
         run_offline_s=wall)

    # the unfused chain: shift block, then the plain FIR kernel
    n_unfused = 3
    audio_u, launches_u, hz_u, wall_u = drive_path(
        torch, wfm.wfm_advanced(shift_rate=SHIFT, fuse_shift=False),
        x[: n_unfused * CHUNK], "wfm_advanced(fuse_shift=False)")
    require(launches_u == {"shift_fir_decimate": 0,
                           "fir_decimate": n_unfused},
            f"unfused launches {launches_u} for {n_unfused} chunks")
    unf_snr = snr_db(audio[: len(audio_u)], audio_u)
    require(unf_snr >= AUDIO_BAR, f"fused vs unfused: {unf_snr:.1f} dB")
    emit("path", pipeline="wfm_advanced(shift_rate=-0.2, fuse_shift=False)",
         chunks=n_unfused, tone_hz=hz_u, launches=launches_u,
         fused_vs_unfused_snr_db=unf_snr, run_offline_s=wall_u)
    return x, launches, launches_u, wall, chunks


def throughput(torch, pipe, xs):
    """Step time of ``pipe`` on device-resident chunks ``xs`` (CUDA events),
    the same steps queued ahead of the device, and each block alone on the
    input it gets in the chain."""
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    box = {"state": pipe.init(dev), "i": 0}

    def step():
        box["state"], y = pipe(box["state"], xs[box["i"] % len(xs)])
        box["i"] += 1
        return y

    with torch.no_grad():
        step_ms = time_cuda(step, iters=10, warmup=3, repeats=5)
        # the same steps queued behind a spin kernel: the device's own time
        # per step, as if the host issued launches instantly
        device_ms = time_cuda(step, iters=10, warmup=1, repeats=5,
                              queue_ahead_ms=100.0)
        per_block, state, v = {}, pipe.init(dev), xs[0]
        for _ in range(2):
            state, _ = pipe(state, xs[0])
        for blk, st in zip(pipe.blocks, state):
            ms = time_cuda(lambda b=blk, s=st, u=v: b(s, u), iters=10,
                           warmup=2, repeats=5)
            per_block[blk.name] = ms
            _, v = blk(st, v)
    n = xs[0].shape[0]
    return {"chunk": n, "step_ms": step_ms, "msps": n / step_ms / 1e3,
            "device_ms": device_ms, "device_busy_share": device_ms / step_ms,
            "per_block_ms": per_block}


TP_NOTE = ("step_ms: CUDA events around back-to-back pipeline steps on "
           "device-resident chunks; device_ms: the same steps queued ahead "
           "of the device; run_offline_msps: host clock, host-to-device "
           "copies and output back to the host included")


def phase_throughput(torch, x, wall, chunks):
    from csdr_tpu_torch.models import wfm

    dev = torch.device("cuda")
    pipe = wfm.wfm_advanced(shift_rate=SHIFT).to(dev)
    xs = [torch.from_numpy(x[c * CHUNK:(c + 1) * CHUNK]).to(dev)
          for c in range(4)]
    tp = throughput(torch, pipe, xs)
    emit("throughput", pipeline="wfm_advanced(shift_rate=-0.2)", **tp,
         run_offline_msps=chunks * CHUNK / wall / 1e6, note=TP_NOTE)


# ---------------------------------------------------------------------------
# the fastddc channelizer (paths A, A', B) and the SSB receiver (path C)
# ---------------------------------------------------------------------------

def reset_all() -> None:
    from csdr_tpu_torch.kernels import fastddc_cuda, fft_cuda, fir_cuda
    for mod in (fir_cuda, fft_cuda, fastddc_cuda):
        mod.reset_launches()


def launches_all() -> dict:
    from csdr_tpu_torch.kernels import fastddc_cuda, fft_cuda, fir_cuda
    return {**fir_cuda.LAUNCHES, **fft_cuda.LAUNCHES, **fastddc_cuda.LAUNCHES}


def require_launches(got: dict, want: dict, what: str) -> None:
    full = {k: want.get(k, 0) for k in got}
    require(got == full, f"{what}: launches {got}, want {full}")


def tones(n: int, freqs, seed: int, noise: float = 0.5) -> np.ndarray:
    """Unit complex tones at ``freqs`` (cycles/sample, float64 phase) plus
    complex white noise of std ``noise`` per part, so that every channel
    carries signal."""
    rng = np.random.default_rng(seed)
    s = np.arange(n, dtype=np.float64)
    x = noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for f in freqs:
        x += np.exp(2j * np.pi * np.mod(f * s, 1.0))
    return x.astype(np.complex64)


def checked_channels(rates, gap: float = 0.1, most: int = 6) -> list[int]:
    """Channels at least ``gap`` apart, so each checked channel's passband
    holds its own test tone and no other."""
    picked: list[int] = []
    for k in np.argsort(rates):
        if all(abs(rates[k] - rates[j]) > gap for j in picked):
            picked.append(int(k))
    return picked[:most]


def peak_cycles(y: np.ndarray) -> float:
    """Frequency of the strongest bin, cycles/sample in [-0.5, 0.5)."""
    spec = np.abs(np.fft.fft(y * np.hanning(len(y))))
    f = np.argmax(spec) / len(y)
    return f - 1.0 if f >= 0.5 else f


def stream(torch, pipe, x: np.ndarray, chunk: int, dev) -> list:
    """A block or pipeline over ``x`` in chunks on ``dev``, as a user calls
    it; the valid outputs per chunk, synchronised."""
    from csdr_tpu_torch import VarOut
    state, outs = pipe.init(dev), []
    with torch.no_grad():
        for c in range(len(x) // chunk):
            state, y = pipe(state, torch.from_numpy(
                x[c * chunk:(c + 1) * chunk]).to(dev))
            outs.append(y.compact() if isinstance(y, VarOut) else y)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return outs


def check_tones(outs, checked, want: float, what: str) -> dict:
    """Each checked channel's test tone, over all chunks, at ``want``."""
    got = {}
    for k in checked:
        got[k] = peak_cycles(np.concatenate([o[k].cpu().numpy()
                                             for o in outs]))
        require(abs(got[k] - want) < 1e-3,
                f"{what}: channel {k} tone at {got[k]:.5f}, want {want}")
    return got


def phase_fastddc_paths(torch):
    import copy

    from csdr_tpu_torch import Pipeline
    from csdr_tpu_torch.ops import fastddc as fd

    require_no_tf32(torch)
    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    rates = bench_rates()
    checked = checked_channels(rates)
    result = {}

    # A: the channelizer at D=16
    ddc = fd.fastddc_init(0.05, 16)
    chunk = FRAMES_A * ddc.input_size
    delta = 0.01                           # in each checked passband
    x = tones(CHUNKS_A * chunk, [-rates[k] + delta for k in checked], 5)
    chan_cpu = fd.fastddc_channelizer_block(ddc, rates)
    chan = copy.deepcopy(chan_cpu).to(dev)
    reset_all()
    t0 = time.perf_counter()
    outs = stream(torch, chan, x, chunk, dev)
    wall = time.perf_counter() - t0
    launches = launches_all()
    require_launches(launches, {"fastddc_inv": CHUNKS_A}, "path A")
    m = ddc.post_input_size // ddc.post_decimation
    require(all(tuple(o.shape) == (CHANNELS, FRAMES_A * m) for o in outs),
            "path A: output shape")
    require(all(bool(torch.isfinite(torch.view_as_real(o)).all())
                for o in outs), "path A: non-finite output")
    got = check_tones(outs, checked, delta * 16, "path A")

    def first_chunk(blk, device):
        return stream(torch, blk, x[:chunk], chunk, device)[0].cpu().numpy()

    cpu0 = first_chunk(chan_cpu, cpu)
    card0 = outs[0].cpu().numpy()
    snr_cpu = require_match(
        "path_A: card vs CPU", card0, cpu0, CHANNEL_BAR, x[:chunk],
        lambda: first_chunk(chan, dev), lambda: first_chunk(chan_cpu, cpu),
        frame=m)
    # the same chunk with TF32 switched on globally: the channelizer's
    # split-DFT product runs in full float32 all the same
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card_tf32 = first_chunk(chan, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    snr_tf32 = require_match("path_A_tf32_on: card vs CPU", card_tf32, cpu0,
                             CHANNEL_BAR, frame=m)
    emit("path", path="A", pipeline="fastddc_channelizer_block("
         "fastddc_init(0.05, 16), 64 rates)", chunks=CHUNKS_A, chunk=chunk,
         launches=launches, tones_at=got, tone_want=delta * 16,
         card_vs_cpu_min_channel_snr_db=snr_cpu,
         tf32_on_card_vs_cpu_min_channel_snr_db=snr_tf32,
         tf32_on_bitwise_equal=bool(np.array_equal(card_tf32, card0)),
         stream_s=wall)
    result["A"] = (launches, chan, x, chunk, wall)

    # A': the forward block and the inverse block at D=16
    pipe = Pipeline([fd.fastddc_fwd_block(ddc),
                     fd.fastddc_inv_block(ddc, rates)],
                    name="fastddc16 fwd|inv").to(dev)
    reset_all()
    outs_ap = stream(torch, pipe, x[:CHUNKS_AP * chunk], chunk, dev)
    launches_ap = launches_all()
    require_launches(launches_ap, {"fastddc_inv": CHUNKS_AP}, "path A'")
    snr_ap = min(require_match("path_A'_vs_A: chunk", b.cpu().numpy(),
                               a.cpu().numpy(), CHANNEL_BAR, frame=m)
                 for a, b in zip(outs, outs_ap))
    emit("path", path="A'", pipeline="fastddc_fwd_block(ddc16) | "
         "fastddc_inv_block(ddc16, 64 rates)", chunks=CHUNKS_AP,
         launches=launches_ap, vs_path_a_min_channel_snr_db=float(snr_ap))
    del outs, outs_ap

    # B: kernel-order forward and the classed inverse at D=50
    ddc = fd.fastddc_init(0.05, 50)
    chunk = FRAMES_B * ddc.input_size
    delta = 0.004
    x = tones(CHUNKS_B * chunk, [-rates[k] + delta for k in checked], 6)
    pipe_cpu = Pipeline([
        fd.fastddc_fwd_block(ddc, spectra_order="kernel"),
        fd.fastddc_inv_block(ddc, rates, spectra_order="kernel")],
        name="fastddc50")
    pipe = copy.deepcopy(pipe_cpu).to(dev)
    reset_all()
    t0 = time.perf_counter()
    outs = stream(torch, pipe, x, chunk, dev)
    wall = time.perf_counter() - t0
    launches = launches_all()
    require_launches(launches, {"fft_ko": CHUNKS_B}, "path B")
    require(all(bool(torch.isfinite(torch.view_as_real(o)).all())
                for o in outs), "path B: non-finite output")
    got = check_tones(outs, checked, delta * 50, "path B")

    def first_chunk_b(blk, device):
        return stream(torch, blk, x[:chunk], chunk, device)[0].cpu().numpy()

    snr_cpu = require_match(
        "path_B: card vs CPU", outs[0].cpu().numpy(),
        first_chunk_b(pipe_cpu, cpu), CHANNEL_BAR, x[:chunk],
        lambda: first_chunk_b(pipe, dev),
        lambda: first_chunk_b(pipe_cpu, cpu), frame=ddc.post_input_size)
    emit("path", path="B", pipeline="fastddc_fwd_block(ddc50, kernel "
         "order) | fastddc_inv_block(ddc50, 64 rates, kernel order)",
         chunks=CHUNKS_B, chunk=chunk, launches=launches, tones_at=got,
         tone_want=delta * 50,
         card_vs_cpu_min_channel_snr_db=snr_cpu, stream_s=wall)
    result["B"] = (launches, pipe, x, chunk, wall)
    return result


def phase_ssb_path(torch):
    from csdr_tpu_torch import run_offline
    from csdr_tpu_torch.models import receivers

    require_no_tf32(torch)
    n = CHUNKS_C * CHUNK_C
    s = np.arange(n, dtype=np.float64)
    x = np.exp(2j * np.pi * np.mod(0.0005 * s, 1.0)).astype(np.complex64)
    pipe = receivers.ssb_receiver(0.0, 0.1, 0.05, decimation=50,
                                  agc_on=False)
    reset_all()
    t0 = time.perf_counter()
    audio = run_offline(pipe, x, block_size=CHUNK_C)
    wall = time.perf_counter() - t0
    launches = launches_all()
    require_launches(launches, {"fir_decimate": CHUNKS_C, "fft_ko": CHUNKS_C,
                                "ifft_ko": CHUNKS_C}, "path C")
    require(audio.dtype == np.float32 and np.all(np.isfinite(audio))
            and len(audio) == n // 50, "path C: audio not finite float32")
    peak = abs(peak_cycles(audio[2000:]))       # real audio: +-f mirror
    require(abs(peak - 0.0005 * 50) < 0.002, f"path C: tone at {peak}")
    # a tone at -0.004 lands at -0.2 after decimation: outside the USB band
    x2 = np.exp(-2j * np.pi * np.mod(0.004 * s[:2 * CHUNK_C], 1.0)
                ).astype(np.complex64)
    audio2 = run_offline(pipe, x2, block_size=CHUNK_C)
    reject = float(np.abs(audio2[2000:]).mean()
                   / np.abs(audio[2000: len(audio2)]).mean())
    require(reject < 0.02, f"path C: out-of-band tone passes at {reject}")
    def ssb_on(device):
        return run_offline(receivers.ssb_receiver(
            0.0, 0.1, 0.05, decimation=50, agc_on=False), x[:2 * CHUNK_C],
            block_size=CHUNK_C, device=device)

    cpu = ssb_on("cpu")
    cpu_snr = require_match("path_C: card vs CPU audio", audio[: len(cpu)],
                            cpu, SSB_BAR, x[:2 * CHUNK_C],
                            lambda: ssb_on("cuda"), lambda: ssb_on("cpu"),
                            frame=CHUNK_C // 50)
    emit("path", path="C", pipeline="ssb_receiver(0.0, 0.1, 0.05, "
         "decimation=50, agc_on=False)", chunks=CHUNKS_C, chunk=CHUNK_C,
         launches=launches, tone_cycles=peak, tone_want=0.025,
         out_of_band_ratio=reject, card_vs_cpu_snr_db=cpu_snr,
         run_offline_s=wall)
    return launches, pipe, x, wall


def phase_new_throughput(torch, paths, ssb):
    from csdr_tpu_torch import Pipeline

    dev = torch.device("cuda")
    labels = {"A": "fastddc_channelizer_block(ddc16, 64 rates)",
              "B": "fastddc_fwd_block | fastddc_inv_block, D=50, kernel "
                   "order, 64 rates"}
    for key, label in labels.items():
        _, pipe, x, chunk, wall = paths[key]
        if not isinstance(pipe, Pipeline):
            pipe = Pipeline([pipe], name=label)
        xs = [torch.from_numpy(x[c * chunk:(c + 1) * chunk]).to(dev)
              for c in range(min(3, len(x) // chunk))]
        tp = throughput(torch, pipe, xs)
        emit("throughput", path=key, pipeline=label, **tp,
             stream_msps=(len(x) // chunk) * chunk / wall / 1e6,
             note=TP_NOTE.replace("run_offline_msps", "stream_msps"))
    _, pipe, x, wall = ssb
    xs = [torch.from_numpy(x[c * CHUNK_C:(c + 1) * CHUNK_C]).to(dev)
          for c in range(3)]
    tp = throughput(torch, pipe.to(dev), xs)
    emit("throughput", path="C", pipeline="ssb_receiver(agc_on=False)", **tp,
         run_offline_msps=CHUNKS_C * CHUNK_C / wall / 1e6, note=TP_NOTE)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    return run(torch)


def run(torch) -> int:
    """Every phase, in order; ``torch`` is the torch module."""
    from csdr_tpu_torch.kernels import _build

    smi = phase_env(torch, _build)
    cases, _ = phase_kernels(torch)
    new_cases = phase_fastddc_kernels(torch)
    x, launches, launches_u, wall, chunks = phase_path(torch)
    phase_throughput(torch, x, wall, chunks)
    paths = phase_fastddc_paths(torch)
    ssb = phase_ssb_path(torch)
    phase_new_throughput(torch, paths, ssb)

    # launches of each kernel on the path that gives it its shape: K1 from
    # wfm_advanced, K2 from the unfused chain and from C, K3 forward from B
    # and C, K3 inverse from C, K4 from A
    paths_of = {
        "wfm": ("wfm_advanced(shift_rate=-0.2)", launches),
        "wfm_unfused": ("wfm_advanced(shift_rate=-0.2, fuse_shift=False)",
                        launches_u),
        "A": ("A: fastddc_channelizer_block(ddc16)", paths["A"][0]),
        "B": ("B: fastddc50 fwd (kernel order) | classed inverse",
              paths["B"][0]),
        "C": ("C: ssb_receiver(agc_on=False)", ssb[0])}
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "path")
    table = []
    for c in cases + new_cases:
        path, counts = paths_of[c["path"]]
        c = dict(c, launches=counts[c["name"]], path=path)
        require(c["launches"] > 0, f"{c['name']} not launched on its path")
        table.append({k: c[k] for k in keys})
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
