#!/usr/bin/env python3
"""K1 and K2 (the decimating FIR pair) and paths WFM, C and D on two trees
of this repository, in turns on one GPU:

    git archive <parent> | tar -x -C build/parent     # build/ is git-ignored
    python3 tools/k2_ab.py build/parent .

Each tree's own ``chip_smoke.kernel_case`` (K1 and K2 at chip_smoke.py's
shapes: the WFM front end D=10/T=79 fused and unfused, D=50/T=801 of paths
C, E and F, D=50/T=81 of path D, and the BASELINE headline D=10/T=1023)
and ``chip_smoke.throughput`` (wfm_advanced, ssb_receiver(agc_on=False)
and nfm_receiver, each on three or four device-resident chunks) run in a
fresh process started in that tree, in the order parent, change, change,
parent.  Each run also computes K1 and K2 once on one input per shape made
from a numpy seed; every run's outputs must equal the first run's bit for
bit.  Prints the card's name and power limit, one JSON line per run, then
the bit-for-bit verdict; exits non-zero if a run fails or an output
differs.  Each tree builds its kernels into its own build/ directory.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

# (name, D, T, kout, rate, theta, seed): chip_smoke.py's K1/K2 cases
CASES = (("shift_fir_decimate", 10, 79, 240_000, -0.2, 0.3, 1),
         ("fir_decimate", 10, 79, 240_000, 0.0, 0.0, 2),
         ("fir_decimate", 50, 801, 48_060, 0.0, 0.0, 16),
         ("fir_decimate", 50, 81, 48_000, 0.0, 0.0, 26),
         ("fir_decimate", 10, 1023, 262_144, 0.0, 0.0, 3))

RUN = r'''
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from csdr_tpu_torch import firdes
from csdr_tpu_torch.kernels import fir_cuda
from csdr_tpu_torch.models import receivers, wfm
cases, dump = json.loads(sys.argv[1]), sys.argv[2]
dev = torch.device("cuda")
out, ys = {}, {}
for name, d, t, kout, rate, theta, seed in cases:
    c = cs.kernel_case(torch, name, d, t, kout, rate, theta, seed)
    key = f"{name} D={d} T={t}"
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "snr_db"):
        out[f"{key} {k}"] = c[k]
    rng = np.random.default_rng(seed)
    tail_len = ((t - 1 + d - 1) // d) * d
    v = (rng.standard_normal(tail_len + kout * d)
         + 1j * rng.standard_normal(tail_len + kout * d)).astype(np.complex64)
    v = torch.from_numpy(v).to(dev)
    taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
    phase = (rate, theta) if name == "shift_fir_decimate" else ()
    y = getattr(fir_cuda, name)(v[:tail_len], v[tail_len:], taps, d, kout,
                                *phase)
    ys[key] = y.cpu().numpy()
np.savez(dump, **ys)
x = cs.fm_tone(4 * cs.CHUNK)
xw = [torch.from_numpy(x[i * cs.CHUNK:(i + 1) * cs.CHUNK]).to(dev)
      for i in range(4)]
s = np.arange(3 * cs.CHUNK_C, dtype=np.float64)
xc = np.exp(2j * np.pi * np.mod(0.0005 * s, 1.0)).astype(np.complex64)
xcs = [torch.from_numpy(xc[i * cs.CHUNK_C:(i + 1) * cs.CHUNK_C]).to(dev)
       for i in range(3)]
xd = cs.fm_tone(3 * cs.CHUNK, carrier=0.0, dev=5_000.0)
xds = [torch.from_numpy(xd[i * cs.CHUNK:(i + 1) * cs.CHUNK]).to(dev)
       for i in range(3)]
pipes = (("WFM", wfm.wfm_advanced(shift_rate=cs.SHIFT), xw),
         ("C", receivers.ssb_receiver(0.0, 0.1, 0.05, decimation=50,
                                      agc_on=False), xcs),
         ("D", receivers.nfm_receiver(decimation=50,
                                      audio_rate=cs.AUDIO_RATE,
                                      fastagc_block_size=cs.CHUNK // 50),
          xds))
for key, pipe, xs in pipes:
    tp = cs.throughput(torch, pipe.to(dev), xs)
    out.update({f"{key} {k}": tp[k] for k in ("step_ms", "msps", "device_ms",
                                              "device_busy_share")})
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
