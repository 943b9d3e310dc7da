#!/usr/bin/env python3
"""Memory-safety and repeatability checks of csdr_tpu_torch's CUDA kernels
on one GPU, at the shapes chip_smoke.py's paths give them plus ragged and
opt-in shared-memory shapes:

    python3 check_kernels.py [--repeats 500]

1. guard bands: each kernel's C entry point writes its output into the
   middle of a buffer whose head and tail hold a sentinel; the sentinel
   must survive and the output must equal the wrapper's bit for bit (an
   out-of-range store shows here); K1/K2 also under the smallest and the
   largest tile the kernel takes at each shape, and so is K5;
2. repeats: K1 and K2 (the WFM front end, paths D's and C's shapes, the
   BASELINE headline), K3 forward and inverse (paths B's and
   C's shapes and the 128 KB frame), K4 (path A's) and K5 (its nine
   shapes) run
   ``--repeats`` times on one input, and one chunk of path A's
   channelizer a fifth as often; every result must equal the first bit for bit
   (a shared-memory race shows as run-to-run differences);
3. one chunk of path A and one of path C through their entry points.

It prints one JSON line per check and exits non-zero at the first
failure.  The same script is the target for NVIDIA's compute-sanitizer
where that attaches (``compute-sanitizer --tool memcheck python3
check_kernels.py --repeats 1``, also ``--tool racecheck``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

GUARD = 4096                        # sentinel elements on each side
SENTINEL = complex(-2.0 ** 100, 0.375)   # exact in complex64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=500)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("check_kernels: CUDA is not available", file=sys.stderr)
        return 2
    return run(torch, args.repeats)


def run(torch, repeats: int) -> int:
    """Every check above; ``torch`` is the torch module."""
    import chip_smoke as cs
    from csdr_tpu_torch import firdes, run_offline
    from csdr_tpu_torch.kernels import _build, fastddc_cuda, fft_cuda, fir_cuda
    from csdr_tpu_torch.models import receivers
    from csdr_tpu_torch.ops import fastddc as fd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = _build.lib()

    def cn(*shape):
        return torch.randn(*shape, dtype=torch.complex64, device=dev,
                           generator=gen)

    def guarded(what, want, launch):
        """``launch(ptr)`` writes ``want.numel()`` complex64 at ``ptr``."""
        n = want.numel()
        guard = torch.full((GUARD,), SENTINEL, dtype=torch.complex64,
                           device=dev)
        buf = torch.cat([guard, torch.zeros_like(want.reshape(-1)), guard])
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(launch(buf[GUARD:].data_ptr(), stream), what)
        torch.cuda.synchronize()
        head, body, tail = buf[:GUARD], buf[GUARD:GUARD + n], buf[GUARD + n:]
        ok = torch.equal(head, guard) and torch.equal(tail, guard)
        same = torch.equal(body, want.reshape(-1))
        cs.emit("guard", kernel=what, elements=n, guards_intact=ok,
                equals_wrapper=same)
        cs.require(ok and same, f"{what}: guard bands {ok}, equal {same}")

    def repeat(what, fn, times):
        y0 = fn()
        torch.cuda.synchronize()
        diff = 0
        for _ in range(times - 1):
            if not torch.equal(fn(), y0):
                diff += 1
        cs.emit("repeat", kernel=what, runs=times, differing_runs=diff)
        cs.require(diff == 0, f"{what}: {diff} of {times} runs differ")

    # K1, K2: the WFM front end fused and unfused, path D's D=50/T=81, path
    # C's D=50/T=801 (opt-in shared memory), the BASELINE headline shape
    # and a ragged output count, each under the planner's launch and under
    # the smallest and largest tile the kernel takes there
    fir_cases = (("shift_fir_decimate", 10, 79, 240_000),
                 ("fir_decimate", 10, 79, 240_000),
                 ("fir_decimate", 50, 81, cs.CHUNK // 50),
                 ("fir_decimate", 50, 801, cs.CHUNK_C // 50),
                 ("fir_decimate", 10, 1023, 262_144),
                 ("fir_decimate", 50, 801, 777))
    for name, d, t, kout in fir_cases:
        tail_len = ((t - 1 + d - 1) // d) * d
        tl, x = cn(tail_len), cn(kout * d)
        taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
        phase = (-0.2, 0.3) if name == "shift_fir_decimate" else ()
        kern = getattr(fir_cuda, name)
        y = kern(tl, x, taps, d, kout, *phase)
        every = fir_cuda.plans(t, d, kout, bool(phase))
        for plan in (fir_cuda.plan_tile(t, d, kout, bool(phase)),
                     min(every, key=lambda p: p["tile"]),
                     max(every, key=lambda p: p["tile"])):
            guarded(f"{name} D={d} T={t} kout={kout} tile {plan['tile']} "
                    f"R={plan['per_thread']} S={plan['groups']}", y,
                    lambda p, s, f=getattr(lib, "csdr_" + name), pl=plan: f(
                        tl.data_ptr(), tail_len, x.data_ptr(), x.shape[0],
                        taps.data_ptr(), t, d, kout, p, *phase, pl["tile"],
                        pl["per_thread"], pl["groups"], s))
        if kout != 777:
            repeat(f"{name} D={d} T={t}", lambda: kern(
                tl, x, taps, d, kout, *phase), repeats)
    # K3: paths B and C, ragged batches, the opt-in 128 KB frame
    for n, b in ((1024, cs.FRAMES_B), (256, cs.CHUNK_C // 8900), (256, 5),
                 (128, 9), (16384, 3)):
        x = cn(b, n)
        tw = torch.from_numpy(fft_cuda.twiddles(n)).to(dev)
        for name in ("fft_ko", "ifft_ko"):
            y = getattr(fft_cuda, name)(x)
            guarded(f"{name} N={n} B={b}", y,
                    lambda p, s, f=getattr(lib, "csdr_" + name): f(
                        x.data_ptr(), p, tw.data_ptr(), n, b, s))
            if (n, b) in ((1024, cs.FRAMES_B), (256, cs.CHUNK_C // 8900),
                          (16384, 3)):
                repeat(f"{name} N={n} B={b}",
                       lambda f=getattr(fft_cuda, name): f(x), repeats)
    # K4: path A's plan, D=4, D=256, 256 channels x 512 frames (csdr_tpu's
    # fastddc256 bench), ragged frames and channels
    rates = cs.bench_rates()
    rates256 = np.random.default_rng(0).uniform(-0.4, 0.4, 256)
    for d, b, c in ((16, cs.FRAMES_A, 64), (4, cs.FRAMES_A, 64),
                    (256, cs.FRAMES_A, 64), (16, 512, 256), (16, 45, 5),
                    (256, 3, 9)):
        ddc = fd.fastddc_init(0.05, d)
        tq, w, dd, cyc = fd.channel_factored2_arrays(
            ddc, (rates if c <= 64 else rates256)[:c])
        rot = np.exp(2j * np.pi * np.mod(np.arange(b)[None, :]
                                         * cyc[:, None], 1.0))
        mats = [torch.from_numpy(np.ascontiguousarray(a, np.complex64))
                .to(dev) for a in (tq, w, dd, rot)]
        s_in, m = cn(b, ddc.fft_size), w.shape[1]
        tiles = fastddc_cuda.plan_tiles(tq.shape[1], tq.shape[2], m)
        y = fastddc_cuda.fastddc_inv(s_in, *mats, m)
        guarded(f"fastddc_inv D={d} B={b} C={c} tiles {tiles}", y,
                lambda p, s: lib.csdr_fastddc_inv(
                    s_in.data_ptr(), *(t.data_ptr() for t in mats), p, b, c,
                    tq.shape[1], tq.shape[2], m, m, m, tiles["kc"],
                    tiles["mt"], tiles["jc"], s))
        if (d, b) == (16, cs.FRAMES_A):
            repeat(f"fastddc_inv D={d} B={b} C={c}", lambda: (
                fastddc_cuda.fastddc_inv(s_in, *mats, m)), repeats)

    # K5: path P's tail-extended chunk, the BASELINE headline, NFM's front
    # end, m = 1 (T <= D), ragged kout, a kout below one tile and odd D with
    # odd M (a tap table of an odd number of floats), each under the
    # planner's launch and under the smallest and largest tile the kernel
    # takes there, and repeated
    poly_cases = ((10, 1023, cs.CHUNK // 10, 1030 + cs.CHUNK),
                  (10, 1023, 262_144, 0), (50, 81, 48_000, 0),
                  (10, 7, 240_000, 0), (50, 49, 1001, 0), (50, 801, 777, 0),
                  (50, 81, 13, 0), (3, 79, 5000, 0), (1, 33, 4000, 0))
    for d, t, kout, n in poly_cases:
        n = n or (kout - 1) * d + t
        xcat = cn(n)
        taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
        y = fir_cuda.fir_decimate_poly(xcat, taps, d, kout)
        every = fir_cuda.poly_plans(t, d, kout)
        for plan in (fir_cuda.poly_plan(t, d, kout),
                     min(every, key=lambda p: p["tile"]),
                     max(every, key=lambda p: p["tile"])):
            guarded(f"fir_poly D={d} T={t} kout={kout} tile {plan['tile']} "
                    f"R={plan['per_thread']} G={plan['groups']}", y,
                    lambda p, s, pl=plan: lib.csdr_fir_poly(
                        xcat.data_ptr(), n, taps.data_ptr(), t, d, kout,
                        pl["tile"], pl["per_thread"], pl["groups"], p, s))
        repeat(f"fir_poly D={d} T={t} kout={kout}",
               lambda: fir_cuda.fir_decimate_poly(xcat, taps, d, kout),
               repeats)

    # path A: one chunk, repeatedly from a fresh state; then path C
    ddc = fd.fastddc_init(0.05, 16)
    chunk = cs.FRAMES_A * ddc.input_size
    chan = fd.fastddc_channelizer_block(ddc, rates).to(dev)
    xa = torch.from_numpy(cs.tones(chunk, [0.01], 5)).to(dev)

    def path_a():
        with torch.no_grad():
            return chan(chan.init(dev), xa)[1].data

    repeat("path A chunk (fastddc_channelizer_block)", path_a,
           max(1, repeats // 5))
    x = cs.tones(cs.CHUNK_C, [0.0005], 6, noise=0.1)
    audio = run_offline(receivers.ssb_receiver(0.0, 0.1, 0.05, decimation=50,
                                               agc_on=False), x,
                        block_size=cs.CHUNK_C)
    cs.require(np.all(np.isfinite(audio)), "path C: non-finite audio")
    cs.emit("done", launches=cs.launches_all())
    return 0


if __name__ == "__main__":
    sys.exit(main())
