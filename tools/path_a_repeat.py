#!/usr/bin/env python3
"""Is path A the same on every run?  On one GPU:

    python3 tools/path_a_repeat.py [--repeats 40] [--k4-repeats 600]

Streams chip_smoke.py's path A (fastddc_channelizer_block at D=16, 64
channels, 10 chunks of 1024 frames) through the card ``--repeats`` times
and holds every chunk against the port on the CPU (run twice, which must
agree bit for bit) and against the first repeat (bit for bit).  Before
two repeats in three, 2 GiB of device memory is filled with NaN or with
noise and freed, so that a read of memory the path did not write would
change the output.  Then K4 alone on the first chunk's inputs, and the
forward product (cuBLAS) alone, each repeated and held bit for bit to
their first output, with the same fills now and then.  Prints the card's
name and power limit, then one JSON line per finding; exits 1 if any
output changed or fell under chip_smoke.CHANNEL_BAR.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=40)
    ap.add_argument("--k4-repeats", type=int, default=600)
    ap.add_argument("--fwd-repeats", type=int, default=300)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from csdr_tpu_torch.kernels import fastddc_cuda
    from csdr_tpu_torch.ops import fastddc as fd

    if not torch.cuda.is_available():
        print("path_a_repeat: CUDA is not available", file=sys.stderr)
        return 2
    print(cs.nvidia_smi_line(), flush=True)
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    rates = cs.bench_rates()
    checked = cs.checked_channels(rates)
    ddc = fd.fastddc_init(0.05, 16)
    chunk = cs.FRAMES_A * ddc.input_size
    x = cs.tones(cs.CHUNKS_A * chunk, [-rates[k] + 0.01 for k in checked], 5)
    chan_cpu = fd.fastddc_channelizer_block(ddc, rates)
    chan = copy.deepcopy(chan_cpu).to(dev)
    cpu_out = [o.numpy() for o in cs.stream(torch, chan_cpu, x, chunk, cpu)]
    cpu_again = [o.numpy() for o in cs.stream(
        torch, copy.deepcopy(chan_cpu), x, chunk, cpu)]
    ok = all(np.array_equal(a, b) for a, b in zip(cpu_out, cpu_again))
    emit(cpu_rerun_bit_for_bit=ok)

    def fill(kind: str) -> None:
        n = 1 << 28                       # 2 GiB of complex64
        if kind == "nan":
            g = torch.full((n,), float("nan"), dtype=torch.complex64,
                           device=dev)
        else:
            g = 1e3 * torch.randn(n, dtype=torch.complex64, device=dev)
        torch.cuda.synchronize()
        del g

    first, snrs, changed = None, [], 0
    for it in range(args.repeats):
        kind = ("none", "nan", "noise")[it % 3]
        if kind != "none":
            fill(kind)
        outs = [o.cpu().numpy() for o in cs.stream(torch, chan, x, chunk,
                                                   dev)]
        snr = [float(cs.channel_snrs(c, o).min())
               for c, o in zip(cpu_out, outs)]
        first = outs if first is None else first
        same = all(np.array_equal(a, b) for a, b in zip(first, outs))
        changed += not same
        snrs.append(min(snr))
        if it == 0 or not same or min(snr) < cs.CHANNEL_BAR:
            emit(repeat=it, fill=kind, card_vs_cpu_db_per_chunk=snr,
                 bit_for_bit_first=same)
    emit(stream_repeats=args.repeats, chunks=cs.CHUNKS_A,
         card_vs_cpu_min_db=min(snrs), card_vs_cpu_max_db=max(snrs),
         repeats_differing_from_first=changed)
    ok = ok and not changed and min(snrs) >= cs.CHANNEL_BAR

    # K4 alone, and the forward product alone, on the first chunk's inputs
    seen = {}
    launch = fastddc_cuda.fastddc_inv

    def spy(*a):
        seen.setdefault("args", a)
        return launch(*a)

    fastddc_cuda.fastddc_inv = spy
    try:
        cs.stream(torch, copy.deepcopy(chan_cpu).to(dev), x[:chunk], chunk,
                  dev)
    finally:
        fastddc_cuda.fastddc_inv = launch
    k4_args = seen["args"]
    ref = launch(*k4_args).clone()
    plain = fastddc_cuda.fastddc_inv_plain(
        *[a.cpu() if torch.is_tensor(a) else a for a in k4_args])
    bad = 0
    for it in range(args.k4_repeats):
        if it % 50 == 25:
            fill("nan" if it % 100 == 25 else "noise")
        bad += not torch.equal(launch(*k4_args), ref)
    emit(k4_vs_plain_db=float(cs.channel_snrs(
        plain.reshape(plain.shape[0], -1).numpy(),
        ref.reshape(ref.shape[0], -1).cpu().numpy()).min()),
         k4_repeats=args.k4_repeats, k4_repeats_differing=bad)
    ok = ok and not bad

    xs = torch.from_numpy(x[:chunk]).to(dev)
    tail = torch.zeros(ddc.overlap_length, dtype=torch.complex64, device=dev)
    frames = fd.overlap_frames(xs, tail, ddc.input_size, ddc.overlap_length)
    x6 = frames.reshape(frames.shape[0], ddc.fft_inv_size,
                        ddc.pre_decimation).transpose(1, 2)
    fwd = torch.matmul(x6, chan.wdft).clone()
    fwd_cpu = torch.matmul(x6.cpu(), chan_cpu.wdft).numpy()
    bad = 0
    for it in range(args.fwd_repeats):
        if it % 50 == 25:
            fill("noise")
        bad += not torch.equal(torch.matmul(x6, chan.wdft), fwd)
    emit(fwd_card_vs_cpu_db=cs.snr_db(fwd_cpu, fwd.cpu().numpy()),
         fwd_repeats=args.fwd_repeats, fwd_repeats_differing=bad)
    ok = ok and not bad
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
