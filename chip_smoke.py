#!/usr/bin/env python3
"""Smoke run of csdr_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csdr_tpu_torch/csrc (nvcc, at first use), then
prints one JSON line per phase and exits non-zero at the first failure:

1. env: the card, its power limit, the CUDA and nvcc versions, build time.
2. kernels: each FIR kernel against its plain PyTorch version on the same
   inputs on the card (SNR > 110 dB), with its time, the plain version's,
   a one-call library yardstick (conv1d with TF32 off) and the least time
   the card could take (bytes or FP32 operations over the peak rates).
3. path: wfm_advanced over 10 s of an FM-modulated 1 kHz tone at 2.4 Msps
   in 2.4 M-sample chunks, through run_offline on the card: the tone comes
   back, each chunk launched the fused kernel once, and the first 2 chunks
   match the same pipeline on the CPU.  Then the unfused chain
   (fuse_shift=False), which runs the plain FIR kernel.
4. throughput: wfm_advanced's Msps on the card, per chunk and per block.

The second-last lines are the kernel table as one JSON object and the
card's name and power limit as nvidia-smi gives them; the last line is the
result object.  Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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


class SmokeFailure(RuntimeError):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    err = float(np.sum(np.abs(ref - test) ** 2))
    if err == 0.0:
        return float("inf")
    return float(10 * np.log10(np.sum(np.abs(ref) ** 2) / err))


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
    from csdr_tpu_torch.kernels import fir_cuda
    require(lib.csdr_fir_decimate_tile() == fir_cuda.TILE,
            "kernel tile differs from fir_cuda.TILE")
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
    cases = [kernel_case(torch, "shift_fir_decimate", 10, 79, kout, SHIFT,
                         0.3, 1),
             kernel_case(torch, "fir_decimate", 10, 79, kout, 0.0, 0.0, 2)]
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
        {"kernel": "K3 _fft_fwd_kernel/_fft_inv_kernel", "status": "queued"},
        {"kernel": "K4 fastddc _inv_kernel", "status": "queued"},
        {"kernel": "K5 _fir_poly_kernel", "status": "queued"}])
    return cases, headline


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
    cpu = run_offline(wfm.wfm_advanced(shift_rate=SHIFT), x[:2 * CHUNK],
                      block_size=CHUNK, device="cpu")
    cpu_snr = snr_db(cpu, audio[: len(cpu)])
    require(cpu_snr >= AUDIO_BAR and np.allclose(audio[: len(cpu)], cpu,
                                                 rtol=2e-3, atol=5e-4),
            f"card vs CPU audio: {cpu_snr:.1f} dB")
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


def phase_throughput(torch, x, wall, chunks):
    from csdr_tpu_torch.models import wfm
    from csdr_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda")
    pipe = wfm.wfm_advanced(shift_rate=SHIFT).to(dev)
    xs = [torch.from_numpy(x[c * CHUNK:(c + 1) * CHUNK]).to(dev)
          for c in range(4)]
    box = {"state": pipe.init(dev), "i": 0}

    def step():
        box["state"], y = pipe(box["state"], xs[box["i"] % 4])
        box["i"] += 1
        return y

    with torch.no_grad():
        step_ms = time_cuda(step, iters=10, warmup=3, repeats=5)
        # the same steps queued behind a spin kernel: the device's own time
        # per step, as if the host issued launches instantly
        device_ms = time_cuda(step, iters=10, warmup=1, repeats=5,
                              queue_ahead_ms=100.0)
        # each block alone on the input it gets in the chain
        per_block, state, v = {}, pipe.init(dev), xs[0]
        for _ in range(2):
            state, _ = pipe(state, xs[0])
        for blk, st in zip(pipe.blocks, state):
            ms = time_cuda(lambda b=blk, s=st, u=v: b(s, u), iters=10,
                           warmup=2, repeats=5)
            per_block[blk.name] = ms
            _, v = blk(st, v)
    emit("throughput", pipeline="wfm_advanced(shift_rate=-0.2)",
         chunk=CHUNK, step_ms=step_ms, msps=CHUNK / step_ms / 1e3,
         device_ms=device_ms, device_busy_share=device_ms / step_ms,
         per_block_ms=per_block,
         run_offline_msps=chunks * CHUNK / wall / 1e6,
         note="step_ms: CUDA events around back-to-back pipeline steps on "
              "device-resident chunks; device_ms: the same steps queued "
              "ahead of the device; run_offline_msps: host clock, "
              "host-to-device copies and audio back to the host included")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from csdr_tpu_torch.kernels import _build

    smi = phase_env(torch, _build)
    cases, _ = phase_kernels(torch)
    x, launches, launches_u, wall, chunks = phase_path(torch)
    phase_throughput(torch, x, wall, chunks)

    # launches: K1 from the wfm_advanced run, K2 from the unfused one
    paths = {"shift_fir_decimate": ("wfm_advanced(shift_rate=-0.2)",
                                    launches),
             "fir_decimate": ("wfm_advanced(shift_rate=-0.2, "
                              "fuse_shift=False)", launches_u)}
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "path")
    table = []
    for c in cases:
        path, counts = paths[c["name"]]
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
