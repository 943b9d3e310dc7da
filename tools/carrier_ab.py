#!/usr/bin/env python3
"""The Costas and PLL kernels (kernels/carrier_cuda) of two trees of this
repository, in turns on one GPU, timed the same way on both:

    git archive <parent> | tar -x -C build/parent     # build/ is git-ignored
    python3 tools/carrier_ab.py build/parent .

Each tree runs in a fresh process started in that tree, in the order
parent, change, change, parent, with its own kernels.  The cases: the
Costas loop at path G_c's shape (64 rows x 57 344 samples: 8 rows of
chip_smoke.scan_bpsk, 56 of complex noise; the bank's loop constants) in
both error modes, and the PLL (PI and P, pll_cc 2 0.01's constants) at
X''s shape (one row of 65 536 samples of chip_smoke.scan_tone).  Each is
timed as chip_smoke times its kernels (utils/timing.time_cuda, 10 calls
queued behind a spin kernel, median of 5), with its SM cycles a sample at
chip_smoke.SM_CLOCK_HZ.  Every output must equal the first run's bit for
bit.  Prints the card's name and power limit, one JSON line a run, then
the bit-for-bit verdict; exits non-zero if a run fails or an output
differs."""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

RUN = r'''
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from csdr_tpu_torch.kernels import carrier_cuda
from csdr_tpu_torch.ops import sync
from csdr_tpu_torch.utils.timing import time_cuda

dev = torch.device("cuda")
rows, n = cs.CHANNELS, 57_344
rng = np.random.default_rng(7)
x = (rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n))
     ) / np.sqrt(2)
x[:8] = np.stack([cs.scan_bpsk(n, 70 + r) for r in range(8)])
xc = torch.from_numpy(x.astype(np.complex64)).to(dev)
alpha, beta, bw = sync.costas_loop_params(2 * np.pi / 100)   # G_c's
tone = torch.from_numpy(cs.scan_tone(65_536, 71)).to(dev)
st_c = tuple(torch.zeros(rows, device=dev) for _ in range(3))
st_p = tuple(torch.zeros((), device=dev) for _ in range(3))
pa, pb = sync.pll_loop_params(0.01)
cases = {
    "costas_pi_yre_yim": (lambda: carrier_cuda.costas(
        xc, alpha, beta, bw, False, state=st_c), n),
    "costas_decision_directed": (lambda: carrier_cuda.costas(
        xc, alpha, beta, bw, True, state=st_c), n),
    "pll_pi": (lambda: carrier_cuda.pll(tone, pa, pb, st_p), 65_536),
    "pll_p": (lambda: carrier_cuda.pll(tone, 0.01, None, st_p), 65_536),
}
out, dump = {}, {}
with torch.no_grad():
    for key, (fn, steps) in cases.items():
        got = fn()
        torch.cuda.synchronize()
        flat = list(got[:-1]) + list(got[-1])     # outputs, then state
        for i, t in enumerate(flat):
            dump[f"{key}_{i}"] = t.cpu().numpy()
        ms = time_cuda(fn, iters=10, queue_ahead_ms=20.0)
        out[key] = {"ms": ms,
                    "cycles_a_sample": ms * 1e-3 * cs.SM_CLOCK_HZ / steps}
np.savez(sys.argv[1], **dump)
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
            proc = subprocess.run([sys.executable, "-c", RUN, dump],
                                  cwd=trees[side], capture_output=True,
                                  text=True, timeout=600)
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
                       if k not in ys or first[k].tobytes() != ys[k].tobytes()]
    print(json.dumps({"bit_for_bit": not differ, "outputs": list(first),
                      "differ": differ}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
