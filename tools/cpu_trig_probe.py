#!/usr/bin/env python3
"""Does e^{j theta} on the CPU come out right on its first call?

    python3 tools/cpu_trig_probe.py [--children 150]

Forks ``--children`` fresh children of this interpreter for each way of
computing e^{j theta} on path A's NCO ramp (chip_smoke.py's 64 channels x
1024 frames, float32, as ``fastddc._rotate`` forms it).  Each child first
runs path A's forward product (a complex matmul on the CPU), then the
rotation once, and reports how many values are off by more than 1e-6
from float64 and the largest error.  Ways: ``expj`` (the port's, on
``torch.polar``), ``cos_sin`` (``torch.complex(torch.cos, torch.sin)`` in
float32, MKL's vector math), ``cos_sin_f64`` (the same in float64),
``cos_sin_1thread`` (float32 on one thread).  Prints one JSON line a way
with the children that went wrong; exits 1 if ``expj`` ever did.  Needs
no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--children", type=int, default=150)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from csdr_tpu_torch.core.cplx import expj
    from csdr_tpu_torch.core.precision import full_f32_matmul
    from csdr_tpu_torch.ops import fastddc as fd

    # everything before the fork is numpy or a view: no torch thread runs
    rates = cs.bench_rates()
    checked = cs.checked_channels(rates)
    ddc = fd.fastddc_init(0.05, 16)
    x = cs.tones(cs.FRAMES_A * ddc.input_size,
                 [-rates[k] + 0.01 for k in checked], 5)
    chan = fd.fastddc_channelizer_block(ddc, rates)
    ramp, _ = chan._host_ramps(cs.FRAMES_A)

    def rotation(way: str) -> float:
        frames = fd.overlap_frames(
            torch.from_numpy(x), torch.zeros(ddc.overlap_length,
                                             dtype=torch.complex64),
            ddc.input_size, ddc.overlap_length)
        with full_f32_matmul():
            torch.matmul(frames.reshape(cs.FRAMES_A, ddc.fft_inv_size,
                                        ddc.pre_decimation).transpose(1, 2),
                         chan.wdft)
        theta = 2.0 * np.pi * torch.remainder(
            torch.zeros(len(rates))[:, None] + torch.from_numpy(ramp), 1.0)
        if way == "expj":
            z = expj(theta)
        elif way == "cos_sin_f64":
            t = theta.double()
            z = torch.complex(torch.cos(t), torch.sin(t))
        else:
            if way == "cos_sin_1thread":
                torch.set_num_threads(1)
            z = torch.complex(torch.cos(theta), torch.sin(theta))
        ref = np.exp(1j * theta.numpy().astype(np.float64))
        return np.abs(z.numpy() - ref)

    ok = True
    for way in ("expj", "cos_sin", "cos_sin_f64", "cos_sin_1thread"):
        wrong = []
        for child in range(args.children):
            rd, wr = os.pipe()
            pid = os.fork()
            if pid == 0:
                os.close(rd)
                err = rotation(way)
                os.write(wr, json.dumps([int((err > 1e-6).sum()),
                                         float(err.max())]).encode())
                os._exit(0)
            os.close(wr)
            off, worst = json.loads(os.read(rd, 256))
            os.close(rd)
            os.waitpid(pid, 0)
            if off:
                wrong.append({"child": child, "values_off": off,
                              "max_err": worst})
        print(json.dumps({"way": way, "children": args.children,
                          "children_wrong": len(wrong),
                          "first_wrong": wrong[:4]}), flush=True)
        ok = ok and not (way == "expj" and wrong)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
