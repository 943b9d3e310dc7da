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
   kernel-order FFT pair (K3) at the shapes of paths B and C (the inverse
   also at B's, which runs only the forward), the fastddc
   inverse (K4) at path A's shape, at the D=4 and D=256 plans and at 256
   channels x 512 frames (D=16), also with TF32 on globally (bit for bit
   the same) and with its 3xTF32 tensor-core bound beside the FP32 one; then
   the polyphase FIR (K5) at path P's shape and four others, each also
   against K2 on the same input, with its launch, its share of the bound
   and conv1d's time over its own, and on a stream with a NaN that only
   tap rows m >= M would reach (every output finite, equal to the plain
   version); and K2 at path D's D=50/T=81.
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
7. path P/D/E/F, each driven as path A is:
   P  K5's dispatcher fir_decimate_poly_or_plain over 10 chunks of 2.4 M
      samples at D=10/T=1023, the tail carried by the caller: K5 once per
      chunk, equal to fir_decimate_block (K2) on the stream and, on 2
      chunks, to the port on the CPU;
   D  nfm_receiver(50, 48 ksps audio, fastagc on 48 000-sample blocks) over
      10 s of an NFM 1 kHz tone: K2 once per chunk, the tone, card equals
      CPU on 4 chunks (the fastagc lookahead fills the first 2);
   E  ssb_receiver(0.0, 0.1, 0.05, decimation=50), the full chain with its
      AGC, on path C's input: launches and tone as C, the AGC's output
      level for an input 40 dB quieter within 3 dB, card equals CPU on 2
      chunks from the AGC's start-up on (SSB_SETTLE);
   F  am_receiver() over 10 s of a 1 kHz tone at depth 0.5: K2 once per
      chunk, the tone, card equals CPU on 2 chunks;
   then the AGC's launches and host syncs per chunk (torch.profiler).
8. throughput of D, E and F as for C.

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
TF32_FLOPS = 495e12        # H100 SXM dense TF32 on the tensor cores
KERNEL_SOURCE = "csdr_tpu_torch/csrc/fir_decimate.cu"
FFT_SOURCE = "csdr_tpu_torch/csrc/fft_ko.cu"
INV_SOURCE = "csdr_tpu_torch/csrc/fastddc_inv.cu"
POLY_SOURCE = "csdr_tpu_torch/csrc/fir_poly.cu"
CHANNELS = 64              # BASELINE config 5's channelizer
FRAMES_A = 1024            # bench.py fastddc16: frames per chunk
FRAMES_B = 3200            # bench.py fastddc50
CHUNKS_A, CHUNKS_AP, CHUNKS_B, CHUNKS_C = 10, 3, 3, 10
CHUNK_C = 270 * 8900       # ~1 s at 2.4 Msps, 270 bandpass frames
CHANNEL_BAR = 100.0        # card vs CPU, dB, per channel (fastddc)
SSB_BAR = 110.0            # card vs CPU audio, dB (K2 and K3 in f32 FMA)
CHUNKS_P = 10              # path P: 2.4 M-sample chunks through K5
SSB_SETTLE = 4800          # audio samples of the SSB AGC's start-up (0.1 s)
RECEIVER_BAR = 120.0       # card vs CPU audio, dB, paths D-F (K2 in f32 FMA)
POLY_K2_BAR = 100.0        # K5 vs K2 on one input, dB: two summation orders
AUDIO_RATE = 48_000        # the D=50 receivers' audio rate
MISMATCH_DIR = Path(__file__).resolve().parent / "chiprun_out"
INV_PLANS = (1, 4, 8, 16, 64, 256)   # K4 decimations whose tiles are checked


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


def fm_tone(n: int, fs: float = FS, carrier: float = -SHIFT,
            dev: float = 75_000.0) -> np.ndarray:
    """The verify skill's FM-modulated 1 kHz tone (``dev`` Hz for a full
    scale tone, so a peak deviation of dev/2) on a carrier at
    ``carrier``*fs."""
    t = np.arange(n) / fs
    audio = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    phase = 2 * np.pi * (np.cumsum(audio) * dev / fs
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
    fir_shapes = ((79, 10, CHUNK // 10), (801, 50, CHUNK_C // 50),
                  (81, 50, CHUNK // 50), (1023, 10, 262_144))
    require(all(lib.csdr_fir_decimate_smem_bytes(t, d, p["tile"],
                                                 p["per_thread"]) == p["smem"]
                for t, d, k in fir_shapes for p in fir_cuda.plans(t, d, k)),
            "fir_decimate shared memory differs from fir_cuda.smem_bytes")
    require(all(lib.csdr_fastddc_inv_smem_bytes(t["kc"], t["mt"], t["jc"])
                == t["smem"] for t in map(inv_tiles, INV_PLANS)),
            "fastddc_inv tiles differ from fastddc_cuda.plan_tiles")
    poly_shapes = ((1023, 10, CHUNK // 10), (81, 50, 48_000),
                   (801, 50, 48_061), (7, 10, 240_000), (79, 3, 5000),
                   (33, 1, 4000))
    require(all(lib.csdr_fir_poly_smem_bytes(
                t, d, p["tile"], p["per_thread"], p["groups"]) == p["smem"]
                for t, d, k in poly_shapes
                for p in fir_cuda.poly_plans(t, d, k)),
            "fir_poly shared memory differs from fir_cuda.poly_smem_bytes")
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc.stdout.strip().splitlines()[-1],
         build_s=build.build_seconds, build_and_load_s=load_s,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32)
    return smi


def inv_tiles(d: int) -> dict:
    """K4's tiles (fastddc_cuda.plan_tiles) for fastddc_init(0.05, d)."""
    from csdr_tpu_torch.kernels import fastddc_cuda
    from csdr_tpu_torch.ops import fastddc as fd
    ddc = fd.fastddc_init(0.05, d)
    return fastddc_cuda.plan_tiles(ddc.pre_decimation, ddc.fft_inv_size,
                                   ddc.post_input_size // ddc.post_decimation)


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
    plan = fir_cuda.plan_tile(t, d, kout, mix, torch.cuda.
                              get_device_properties(0).multi_processor_count)
    return {
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": ("csdr_tpu/kernels/fir_pallas.py:226" if mix
                     else "csdr_tpu/kernels/fir_pallas.py:211"),
        "shape": {"D": d, "T": t, "kout": kout, "n": n,
                  "plan": {k: plan[k] for k in ("tile", "per_thread",
                                                "groups", "threads",
                                                "blocks")}},
        "snr_db": snr, "snr_bar_db": SNR_BAR, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "share_of_bound": max(t_bytes, t_ops) / kernel_ms,
        "times_faster_than_library": lib_ms / kernel_ms,
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
        {"kernel": "K5 _fir_poly_kernel", "status": "ported",
         "wrapper": "csdr_tpu_torch.kernels.fir_cuda.fir_decimate_poly"}])
    return cases, headline


def _timed_sets(make, nsets=4):
    """``nsets`` input sets and a picker that cycles them, so a timed loop
    does not find its input in the 50 MB L2 where the sets exceed it."""
    sets = [make(i) for i in range(nsets)]
    it = iter(range(1 << 30))
    return sets, lambda: sets[next(it) % nsets]


def fft_case(torch, name, n, b, seed):
    """K3 (fft_ko or ifft_ko) at (N, B) against its plain version."""
    from csdr_tpu_torch.kernels import _build, fft_cuda
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
        "shape": {"N": n, "B": b, "radix_plan": fft_cuda.radix_plan(n),
                  "frames_per_block":
                      _build.lib().csdr_fft_ko_frames_per_block(n, b)},
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
    # the kernel's 3xTF32 is its own arithmetic: the global flag changes
    # no bit
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y_tf32 = fastddc_cuda.fastddc_inv(sets[0], *mats, m)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    require(np.array_equal(y_tf32.cpu().numpy(), yk),
            f"fastddc_inv D={d}: output changes with allow_tf32")
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
    fold, idft = 8 * b * c * pre * inv, 8 * b * c * inv * m
    flops = fold + idft
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    # the same with the iDFT on the tensor cores in 3xTF32, as the kernel
    # runs it: the fold over the FP32 rate plus three TF32 products of
    # the iDFT's operations over the dense TF32 rate
    t_tc = (fold / FP32_FLOPS + 3 * idft / TF32_FLOPS) * 1e3
    return {
        "name": "fastddc_inv", "route": "cuda", "source": INV_SOURCE,
        "replaces": "csdr_tpu/kernels/fastddc_pallas.py:54",
        "shape": {"D": d, "B": b, "C": c, "pre": pre, "inv": inv, "M": m,
                  "tiles": fastddc_cuda.plan_tiles(pre, inv, m)},
        "snr_db": snr, "snr_bar_db": SNR_BAR,
        "max_abs_err": float(np.max(np.abs(yk - yp))),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_tc_ms": max(t_bytes, t_tc),
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
    with its path; K3's inverse also at path B's shape, and K4 at the D=4
    and D=256 plans and at csdr_tpu's 256-channel D=16 bench shape
    (bench.py fastddc256: 512 frames), on no path."""
    rates = bench_rates()
    frames_c = CHUNK_C // 8900             # bandpass frames of N=256
    cases = [
        dict(fft_case(torch, "fft_ko", 1024, FRAMES_B, 11), path="B"),
        dict(kernel_case(torch, "fir_decimate", 50, 801, CHUNK_C // 50, 0.0,
                         0.0, 16), path="C"),
        dict(fft_case(torch, "fft_ko", 256, frames_c, 17), path="C"),
        dict(fft_case(torch, "ifft_ko", 256, frames_c, 12), path="C"),
        dict(inv_case(torch, 16, FRAMES_A, rates, 13), path="A")]
    others = [fft_case(torch, "ifft_ko", 1024, FRAMES_B, 19)]
    others += [inv_case(torch, d, FRAMES_A, rates, 14 + d) for d in (4, 256)]
    rates256 = np.random.default_rng(0).uniform(-0.4, 0.4, 256)
    others.append(inv_case(torch, 16, 512, rates256, 30))
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
    require_launches(launches, {"shift_fir_decimate": chunks},
                     f"wfm_advanced, {chunks} chunks")
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
    require_launches(launches_u, {"fir_decimate": n_unfused},
                     f"unfused, {n_unfused} chunks")
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


# ---------------------------------------------------------------------------
# K5 and its path (P); the NFM (D), full SSB (E) and AM (F) receivers
# ---------------------------------------------------------------------------

def poly_case(torch, d, t, kout, seed, xlen=None):
    """K5 at one shape against its plain version (>= SNR_BAR) and against
    K2 on the same input; its time, the plain version's, conv1d's and the
    least time.  The stream is (kout-1)*D + T samples, or ``xlen``."""
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.kernels import fir_cuda
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    n = xlen or (kout - 1) * d + t
    gen = torch.Generator(device=dev).manual_seed(seed)
    sets, pick = _timed_sets(lambda i: torch.randn(
        n, dtype=torch.complex64, device=dev, generator=gen))
    taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
    plan = fir_cuda.poly_plan(t, d, kout)
    yk = fir_cuda.fir_decimate_poly(sets[0], taps, d, kout)
    yp = fir_cuda.fir_decimate_poly_plain(sets[0], taps, d, kout)
    y2 = fir_cuda.fir_decimate(sets[0][:0], sets[0], taps, d, kout)
    torch.cuda.synchronize()
    yk, yp, y2 = (v.cpu().numpy() for v in (yk, yp, y2))
    snr, snr_k2 = snr_db(yp, yk), snr_db(y2, yk)
    require(np.all(np.isfinite(yk)), "fir_poly: non-finite output")
    require(snr > SNR_BAR, f"fir_poly D={d} T={t} kout={kout}: SNR "
                           f"{snr:.1f} dB vs plain <= {SNR_BAR}")
    require(snr_k2 >= POLY_K2_BAR, f"fir_poly D={d} T={t} kout={kout}: "
                                   f"{snr_k2:.1f} dB vs K2 < {POLY_K2_BAR}")
    ms = time_cuda(lambda: fir_cuda.fir_decimate_poly(pick(), taps, d, kout),
                   iters=40, queue_ahead_ms=20.0)
    plain_ms = time_cuda(
        lambda: fir_cuda.fir_decimate_poly_plain(pick(), taps, d, kout),
        iters=5, warmup=1, repeats=3)
    planes = [torch.view_as_real(v).T.contiguous()[:, None, :] for v in sets]
    turn = iter(range(1 << 30))
    w = taps.view(1, 1, -1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_ms = time_cuda(lambda: torch.nn.functional.conv1d(
            planes[next(turn) % len(planes)], w, stride=d), iters=40,
            queue_ahead_ms=20.0)
    # least time: the stream and taps read once, the output written once;
    # FP32 operations: 2 FMA (4 flops) per tap per output
    nbytes = 8 * n + 4 * t + 8 * kout
    flops = 4 * t * kout
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return {
        "name": "fir_poly", "route": "cuda", "source": POLY_SOURCE,
        "replaces": "csdr_tpu/kernels/fir_pallas.py:37",
        "shape": {"D": d, "T": t, "kout": kout, "len": n},
        "plan": {k: plan[k] for k in ("tile", "per_thread", "groups",
                                      "threads", "smem", "blocks",
                                      "blocks_per_sm")},
        "snr_db": snr, "snr_bar_db": SNR_BAR, "snr_vs_k2_db": snr_k2,
        "snr_vs_k2_bar_db": POLY_K2_BAR,
        "max_abs_err": float(np.max(np.abs(yk - yp))),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_share": max(t_bytes, t_ops) / ms,
        "library_ms": lib_ms, "library_over_kernel": lib_ms / ms,
        "library_call": "torch.nn.functional.conv1d(stride=D), cuDNN, "
                        "TF32 off, on (re, im) planes",
        "bytes": nbytes, "flops": flops,
    }


def phase_poly_kernels(torch):
    """K5 at path P's shape (the tail-extended 2.4 M-sample chunk) and at
    the four shapes K5 must serve: the BASELINE headline, NFM's front end,
    m = 1 and a ragged kout.  Then K2 at path D's shape (NFM's front end),
    which no earlier path gives it."""
    tail = 1030                     # round_up(T-1, D) at D=10, T=1023
    case_p = dict(poly_case(torch, 10, 1023, CHUNK // 10, 21,
                            xlen=tail + CHUNK), path="P")
    others = [poly_case(torch, 10, 1023, 262_144, 22),
              poly_case(torch, 50, 81, 48_000, 23),
              poly_case(torch, 10, 7, 240_000, 24),
              poly_case(torch, 50, 801, 48_061, 25)]
    case_d = dict(kernel_case(torch, "fir_decimate", 50, 81, CHUNK // 50,
                              0.0, 0.0, 26), path="D")
    for c in [case_p] + others + [case_d]:
        emit("kernels", **c)
    poly_nan_case(torch)
    return [case_p, case_d]


def poly_nan_case(torch):
    """K5 reads exactly its M tap rows: a NaN in a sample that only rows
    m >= M would reach (column kout+1 of a stream of (kout + 8)*D samples
    at D=50/T=81, M=2) leaves every output finite and equal to the plain
    version."""
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.kernels import fir_cuda

    d, t, kout = 50, 81, 48_000
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn((kout + 8) * d, dtype=torch.complex64, device=dev,
                    generator=gen)
    x[(kout + 1) * d] = complex(float("nan"), float("nan"))
    taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
    yk = fir_cuda.fir_decimate_poly(x, taps, d, kout).cpu().numpy()
    yp = fir_cuda.fir_decimate_poly_plain(x, taps, d, kout).cpu().numpy()
    finite = bool(np.all(np.isfinite(yk)))
    snr = snr_db(yp, yk) if finite else float("nan")
    emit("kernels", name="fir_poly", check="no row past M",
         shape={"D": d, "T": t, "kout": kout, "len": len(x),
                "nan_at": (kout + 1) * d},
         finite=finite, snr_db=snr, snr_bar_db=SNR_BAR)
    require(finite, "fir_poly: a NaN only rows m >= M read reached an output")
    require(snr > SNR_BAR, f"fir_poly NaN case: {snr:.1f} dB vs plain")


def phase_poly_path(torch):
    """Path P: the dispatcher over a stream, the tail carried here."""
    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.kernels import fir_cuda
    from csdr_tpu_torch.ops import fir

    d, t = 10, 1023
    tail_len = 1030
    taps = firdes.firdes_lowpass_f(t, 0.5 / d)
    x = tones(CHUNKS_P * CHUNK, [0.003, -0.02], 7)

    def run_p(device, chunks):
        dev = torch.device(device)
        tail = torch.zeros(tail_len, dtype=torch.complex64, device=dev)
        taps_dev = torch.from_numpy(taps).to(dev)
        outs = []
        for c in range(chunks):
            xcat = torch.cat([tail, torch.from_numpy(
                x[c * CHUNK:(c + 1) * CHUNK]).to(dev)])
            outs.append(fir_cuda.fir_decimate_poly_or_plain(
                xcat, taps_dev, d, CHUNK // d))
            tail = xcat[-tail_len:]
        return torch.cat(outs).cpu().numpy()

    reset_all()
    t0 = time.perf_counter()
    y = run_p("cuda", CHUNKS_P)
    wall = time.perf_counter() - t0
    launches = launches_all()
    require_launches(launches, {"fir_poly": CHUNKS_P}, "path P")
    require(np.all(np.isfinite(y)) and len(y) == CHUNKS_P * CHUNK // d,
            "path P: output")
    dev = torch.device("cuda")
    k2 = torch.cat(stream(torch, fir.fir_decimate_block(taps, d).to(dev), x,
                          CHUNK, dev)).cpu().numpy()
    snr_k2 = snr_db(k2, y)
    require(snr_k2 >= SNR_BAR, f"path P vs fir_decimate_block (K2): "
                               f"{snr_k2:.1f} dB < {SNR_BAR}")
    cpu = run_p("cpu", 2)
    snr_cpu = require_match("path_P: card vs CPU", y[: len(cpu)], cpu,
                            SNR_BAR, x[:2 * CHUNK], lambda: run_p("cuda", 2),
                            lambda: run_p("cpu", 2), frame=CHUNK // d)
    emit("path", path="P", pipeline="fir_decimate_poly_or_plain(xcat, "
         "lowpass T=1023, D=10), tail carried by the caller",
         chunks=CHUNKS_P, chunk=CHUNK, launches=launches,
         vs_fir_decimate_block_k2_snr_db=snr_k2, card_vs_cpu_snr_db=snr_cpu,
         stream_s=wall)
    return launches


def receiver_path(torch, key, make, x, chunk, per_chunk, cpu_chunks,
                  settle=0):
    """``make()`` over ``x`` on the card through run_offline, launch counts
    zeroed just before and read just after (``per_chunk`` launches of each
    kernel a chunk); the card's first ``cpu_chunks`` chunks against the
    port on the CPU, from audio sample ``settle`` on, at RECEIVER_BAR."""
    from csdr_tpu_torch import run_offline

    chunks = len(x) // chunk
    reset_all()
    t0 = time.perf_counter()
    audio = run_offline(make(), x, block_size=chunk)
    wall = time.perf_counter() - t0
    launches = launches_all()
    require_launches(launches, {k: chunks for k in per_chunk}, f"path {key}")
    require(audio.dtype == np.float32 and np.all(np.isfinite(audio))
            and len(audio) == chunks * chunk // 50,
            f"path {key}: audio not finite float32")

    def on(device):
        return run_offline(make(), x[: cpu_chunks * chunk], block_size=chunk,
                           device=device)

    cpu = on("cpu")
    snr = require_match(f"path_{key}: card vs CPU audio",
                        audio[settle: len(cpu)], cpu[settle:], RECEIVER_BAR,
                        x[: cpu_chunks * chunk],
                        lambda: on("cuda")[settle:],
                        lambda: on("cpu")[settle:], frame=chunk // 50)
    return audio, launches, wall, snr, cpu


def rms_db(a: np.ndarray) -> float:
    return float(10 * np.log10(np.mean(np.square(a, dtype=np.float64))))


def phase_receiver_paths(torch):
    """Paths D (NFM), E (SSB with its AGC) and F (AM)."""
    from csdr_tpu_torch import run_offline
    from csdr_tpu_torch.models import receivers

    require_no_tf32(torch)
    result = {}

    # D: the reference README's NFM chain at 48 ksps audio
    def nfm():
        return receivers.nfm_receiver(decimation=50, audio_rate=AUDIO_RATE,
                                      fastagc_block_size=CHUNK // 50)
    x = fm_tone(SECONDS * FS, carrier=0.0, dev=5_000.0)
    audio, launches, wall, snr, cpu = receiver_path(
        torch, "D", nfm, x, CHUNK, ("fir_decimate",), 4)
    hz = tone_hz(audio)
    require(abs(hz - 1000.0) < 5.0, f"path D: tone at {hz} Hz, not 1 kHz")
    require(rms_db(cpu[2 * CHUNK // 50:]) > -30.0, "path D: compared "
            "chunks carry no audio")
    emit("path", path="D", pipeline="nfm_receiver(decimation=50, "
         "audio_rate=48000, fastagc_block_size=48000)",
         chunks=len(x) // CHUNK,
         chunk=CHUNK, launches=launches, tone_hz=hz,
         card_vs_cpu_snr_db=snr, run_offline_s=wall)
    result["D"] = (launches, nfm, x, CHUNK, wall)

    # E: the full SSB chain, AGC included, on path C's input
    def ssb():
        return receivers.ssb_receiver(0.0, 0.1, 0.05, decimation=50)
    s = np.arange(CHUNKS_C * CHUNK_C, dtype=np.float64)
    x = np.exp(2j * np.pi * np.mod(0.0005 * s, 1.0)).astype(np.complex64)
    audio, launches, wall, snr, cpu = receiver_path(
        torch, "E", ssb, x, CHUNK_C, ("fir_decimate", "fft_ko", "ifft_ko"),
        2, SSB_SETTLE)
    peak = abs(peak_cycles(audio[2000:]))
    require(abs(peak - 0.0005 * 50) < 0.002, f"path E: tone at {peak}")
    whole = snr_db(cpu, audio[: len(cpu)])
    # the AGC's level: the same input 40 dB quieter, 3 chunks, the last
    # chunk of each within 3 dB
    quiet = run_offline(ssb(), 0.01 * x[:3 * CHUNK_C], block_size=CHUNK_C)
    per = CHUNK_C // 50
    loud_db, quiet_db = rms_db(audio[2 * per:3 * per]), rms_db(quiet[2 * per:])
    require(abs(loud_db - quiet_db) <= 3.0, f"path E: AGC levels "
            f"{loud_db:.2f} and {quiet_db:.2f} dB for inputs 40 dB apart")
    emit("path", path="E", pipeline="ssb_receiver(0.0, 0.1, 0.05, "
         "decimation=50) (agc_on=True)", chunks=CHUNKS_C, chunk=CHUNK_C,
         launches=launches, tone_cycles=peak, tone_want=0.025,
         card_vs_cpu_snr_db=snr, card_vs_cpu_from_audio_sample=SSB_SETTLE,
         card_vs_cpu_whole_snr_db=whole, agc_level_db={
             "input_0_dB": loud_db, "input_minus_40_dB": quiet_db},
         run_offline_s=wall)
    result["E"] = (launches, ssb, x, CHUNK_C, wall)

    # F: the reference's AM chain
    t = np.arange(SECONDS * FS) / FS
    x = (1.0 + 0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.complex64)
    audio, launches, wall, snr, _ = receiver_path(
        torch, "F", receivers.am_receiver, x, CHUNK, ("fir_decimate",), 2)
    hz = tone_hz(audio)
    require(abs(hz - 1000.0) < 5.0, f"path F: tone at {hz} Hz, not 1 kHz")
    emit("path", path="F", pipeline="am_receiver()", chunks=len(x) // CHUNK,
         chunk=CHUNK, launches=launches, tone_hz=hz, card_vs_cpu_snr_db=snr,
         run_offline_s=wall)
    result["F"] = (launches, receivers.am_receiver, x, CHUNK, wall)
    return result


def agc_cost(torch, x_chunk):
    """Launches, host syncs and time of one agc_block (chunked) step on a
    chunk of SSB audio on the card, from torch.profiler's events."""
    from torch.profiler import ProfilerActivity, profile

    from csdr_tpu_torch.ops import agc
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    blk = agc.agc_block()
    a = torch.from_numpy(x_chunk).to(dev)
    state, _ = blk(blk.init(dev), a)        # a continuing chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        blk(state, a)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    device_kernels = sum(1 for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
    ms = time_cuda(lambda: blk(state, a), iters=5, warmup=1, repeats=3)
    return {"samples": len(x_chunk), "ms": ms,
            "cuda_launch_calls": sum(1 for n in names
                                     if n in ("cudaLaunchKernel",
                                              "cuLaunchKernel",
                                              "cudaLaunchKernelExC")),
            "device_kernels": device_kernels,
            "host_syncs": names.count("aten::_local_scalar_dense")}


def phase_receiver_throughput(torch, paths):
    """Throughput of D, E and F as for C, then the AGC's own cost."""
    from csdr_tpu_torch import run_offline

    dev = torch.device("cuda")
    labels = {"D": "nfm_receiver(50, 48000, fastagc 48000)",
              "E": "ssb_receiver(agc_on=True)", "F": "am_receiver()"}
    for key, label in labels.items():
        _, make, x, chunk, wall = paths[key]
        xs = [torch.from_numpy(x[c * chunk:(c + 1) * chunk]).to(dev)
              for c in range(3)]
        tp = throughput(torch, make().to(dev), xs)
        emit("throughput", path=key, pipeline=label, **tp,
             run_offline_msps=(len(x) // chunk) * chunk / wall / 1e6,
             note=TP_NOTE + ("; E and F sync the host once per AGC outer "
                             "round, so their device_ms holds the host's "
                             "gaps" if key in "EF" else ""))
    _, make, x, chunk, _ = paths["E"]
    pre = run_offline(_ssb_pre(make), x[:2 * chunk], block_size=chunk)
    emit("agc_cost", path="E", **agc_cost(torch, pre[chunk // 50:]),
         note="one agc_block (chunked) step on path E's second chunk of "
              "audio; cuda_launch_calls and host_syncs from torch.profiler")


def _ssb_pre(make):
    from csdr_tpu_torch import Pipeline
    pipe = make()
    return Pipeline(list(pipe.blocks)[:3], name="ssb before its AGC")


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
    poly_cases = phase_poly_kernels(torch)
    x, launches, launches_u, wall, chunks = phase_path(torch)
    phase_throughput(torch, x, wall, chunks)
    paths = phase_fastddc_paths(torch)
    ssb = phase_ssb_path(torch)
    phase_new_throughput(torch, paths, ssb)
    launches_p = phase_poly_path(torch)
    receivers = phase_receiver_paths(torch)
    phase_receiver_throughput(torch, receivers)

    # launches of each kernel on the path that gives it its shape: K1 from
    # wfm_advanced, K2 from the unfused chain and from C, K3 forward from B
    # and C, K3 inverse from C, K4 from A, K5 from P, K2 at T=81 from D
    paths_of = {
        "D": ("D: nfm_receiver(decimation=50, audio_rate=48000)",
              receivers["D"][0]),
        "wfm": ("wfm_advanced(shift_rate=-0.2)", launches),
        "wfm_unfused": ("wfm_advanced(shift_rate=-0.2, fuse_shift=False)",
                        launches_u),
        "A": ("A: fastddc_channelizer_block(ddc16)", paths["A"][0]),
        "B": ("B: fastddc50 fwd (kernel order) | classed inverse",
              paths["B"][0]),
        "C": ("C: ssb_receiver(agc_on=False)", ssb[0]),
        "P": ("P: fir_decimate_poly_or_plain, D=10, T=1023", launches_p)}
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "path")
    table = []
    for c in cases + new_cases + poly_cases:
        path, counts = paths_of[c["path"]]
        c = dict(c, launches=counts[c["name"]], path=path)
        require(c["launches"] > 0, f"{c['name']} not launched on its path")
        table.append({k: c[k] for k in keys + ("bound_tc_ms",) if k in c})
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
