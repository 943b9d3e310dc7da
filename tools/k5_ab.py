#!/usr/bin/env python3
"""K5 (the exact-f32 polyphase FIR) and path P on two trees of this
repository, in turns on one GPU:

    git archive <parent> | tar -x -C build/parent     # build/ is git-ignored
    python3 tools/k5_ab.py build/parent .

Each tree's own ``chip_smoke.poly_case`` (K5 at chip_smoke.py's five
shapes: path P's tail-extended chunk D=10/T=1023, the BASELINE headline,
D=50/T=81, m=1 at D=10/T=7 and the ragged D=50/T=801, kout=48 061, with
conv1d's time from the same run) and ``chip_smoke.kernel_case`` (K2 at the
same shapes) run in a fresh process started in that tree, in the order
parent, change, change, parent; then path P (the dispatcher over 10
device-resident chunks of 2.4 M samples, the tail carried), timed with
CUDA events.  Each run also computes K5 once on one input per shape made
from a numpy seed, and keeps path P's output; every run's outputs must
equal the first run's bit for bit.  Prints the card's name and power
limit, one JSON line per run, then the bit-for-bit verdict; exits non-zero
if a run fails or an output differs.  Each tree builds its kernels into
its own build/ directory.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

# (D, T, kout, seed, stream length or 0): chip_smoke.py's K5 cases
CASES = ((10, 1023, 240_000, 21, 1030 + 2_400_000),
         (10, 1023, 262_144, 22, 0), (50, 81, 48_000, 23, 0),
         (10, 7, 240_000, 24, 0), (50, 801, 48_061, 25, 0))

RUN = r'''
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from csdr_tpu_torch import firdes
from csdr_tpu_torch.kernels import fir_cuda
cases, dump = json.loads(sys.argv[1]), sys.argv[2]
dev = torch.device("cuda")
out, ys = {}, {}
for d, t, kout, seed, xlen in cases:
    c = cs.poly_case(torch, d, t, kout, seed, xlen=xlen or None)
    key = f"K5 D={d} T={t} kout={kout}"
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "snr_db"):
        out[f"{key} {k}"] = c[k]
    k2 = cs.kernel_case(torch, "fir_decimate", d, t, kout, 0.0, 0.0, seed)
    out[f"{key} K2 ms"] = k2["ms"]
    rng = np.random.default_rng(seed)
    n = xlen or (kout - 1) * d + t
    v = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
    y = fir_cuda.fir_decimate_poly(torch.from_numpy(v).to(dev), taps, d,
                                   kout)
    ys[key] = y.cpu().numpy()
# path P: the dispatcher over device-resident chunks, the tail carried
d, t, tail_len = 10, 1023, 1030
taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
x = cs.tones(cs.CHUNKS_P * cs.CHUNK, [0.003, -0.02], 7)
xs = [torch.from_numpy(x[i * cs.CHUNK:(i + 1) * cs.CHUNK]).to(dev)
      for i in range(cs.CHUNKS_P)]
def path_p():
    tail = torch.zeros(tail_len, dtype=torch.complex64, device=dev)
    outs = []
    for xc in xs:
        xcat = torch.cat([tail, xc])
        outs.append(fir_cuda.fir_decimate_poly_or_plain(xcat, taps, d,
                                                        cs.CHUNK // d))
        tail = xcat[-tail_len:]
    return torch.cat(outs)
ys["path P"] = path_p().cpu().numpy()
times = []
for _ in range(5):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    path_p()
    stop.record()
    stop.synchronize()
    times.append(start.elapsed_time(stop) / cs.CHUNKS_P)
out["path P chunk ms"] = min(times)
out["path P chunk ms, median of 5"] = sorted(times)[2]
np.savez(dump, **ys)
print("RESULT " + json.dumps(out), flush=True)
'''


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": sys.argv[1], "change": sys.argv[2]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    first, differ = None, []
    with tempfile.TemporaryDirectory() as tmp:
        for i, side in enumerate(("parent", "change", "change", "parent")):
            dump = str(Path(tmp, f"run{i}.npz"))
            proc = subprocess.run(
                [sys.executable, "-c", RUN, json.dumps(CASES), dump],
                cwd=trees[side], capture_output=True, text=True, timeout=600)
            found = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("RESULT ")]
            if proc.returncode or not found:
                print(proc.stdout[-2000:] + proc.stderr[-2000:],
                      file=sys.stderr)
                return 1
            print(json.dumps({"tree": side, **json.loads(found[-1][7:])}),
                  flush=True)
            with np.load(dump) as z:
                ys = {k: z[k] for k in z.files}
            if first is None:
                first = ys
            differ += [f"run {i} ({side}): {k}" for k in first
                       if not np.array_equal(first[k].view(np.uint32),
                                             ys[k].view(np.uint32))]
    print(json.dumps({"bit_for_bit": not differ, "shapes": list(first),
                      "differ": differ}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
