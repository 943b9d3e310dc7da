#!/usr/bin/env python3
"""The chunked AGC's relaxation kernel (csrc/agc.cu) and agc_ff's exact
scan (csrc/agc_exact.cu) on two trees of this repository, in turns on one
GPU:

    git archive <parent> | tar -x -C build/parent     # build/ is git-ignored
    python3 tools/agc_ab.py build/parent .

Each tree runs in a fresh process started in that tree, in the order
parent, change, change, parent, with its own kernels (each tree builds
into its own build/ directory).  In each, ``agc_cuda.relax`` on two inputs
of tests/test_torch_agc_kernel.py, timed as chip_smoke.agc_case times it
(time_cuda, 20 calls queued ahead):

- ``speech``: ``speech_like(48_060, 7)``, six rows of SSB-like audio,
  continuing from gain 3 and hang 10 (entries on the card);
- ``agc_signal``: ``agc_signal()`` from the stream's start, seven rows,
  the last of which never settles.

Each case reports the scans on the chain (per outer round the most of any
row) and the kernel's ms a scan on it.  Then ``agc_cuda.scan`` on the
CLI's chunk as chip_smoke.agc_exact_case times it (65 536 samples of
chip_smoke.agc_exact_input, AGC_EXACT_KW, continuing from gain 1.5 and
peak 0.133 on the card), with its SM cycles a sample at 1980 MHz and the
chain probe's (``agc_cuda.exact_cycles``, the least of three).  Every
output (y, gain, hang, converged; y and the four state values of the
exact scan) must equal the first run's bit for bit.  Prints the card's name
and power limit, one JSON line per run, then the bit-for-bit verdict;
exits non-zero if a run fails or an output differs.
"""

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
sys.path[:0] = [".", "tests"]
from csdr_tpu_torch.kernels import agc_cuda
from csdr_tpu_torch.utils.timing import time_cuda
from test_torch_agc_kernel import agc_signal, speech_like
dump = sys.argv[1]
dev = torch.device("cuda")
cases = {
    "speech": (speech_like(48_060, 7),
               {"started": True, "last_gain": torch.tensor(3.0, device=dev),
                "last_hang": torch.tensor(10, dtype=torch.int32,
                                          device=dev)}),
    "agc_signal": (agc_signal(), {}),
}
out, ys = {}, {}
for name, (x, kw) in cases.items():
    a = torch.from_numpy(x).to(dev)
    *got, table = agc_cuda.relax(a, rounds=True, **kw)
    ms = time_cuda(lambda: agc_cuda.relax(a, **kw), iters=20,
                   queue_ahead_ms=20.0)
    rounds, settled = table.cpu().numpy()
    chain = int((rounds - settled).max(1).sum())
    out[name] = {"samples": len(x), "rows": rounds.shape[1],
                 "scans_on_chain": chain, "ms": ms,
                 "ms_a_scan": ms / chain}
    for k, g in zip(("y", "gain", "hang", "converged"), got):
        ys[f"{name} {k}"] = g.cpu().numpy()
import chip_smoke as cs
x = torch.from_numpy(cs.agc_exact_input(cs.AGC_EXACT_CHUNK, 140)).to(dev)
state = [torch.tensor(np.float32(1.5), device=dev),
         torch.tensor(0, dtype=torch.int32, device=dev),
         torch.tensor(np.float32(0.133), device=dev),
         torch.tensor(0, dtype=torch.int32, device=dev)]
got = agc_cuda.scan(x, *state, started=True, **cs.AGC_EXACT_KW)
ms = time_cuda(lambda: agc_cuda.scan(x, *state, started=True,
                                     **cs.AGC_EXACT_KW),
               iters=20, queue_ahead_ms=20.0)
probe_in = torch.from_numpy(cs.agc_exact_input(agc_cuda.PROBE_MAX, 142)
                            ).to(dev)
probe = min(agc_cuda.exact_cycles(probe_in, **cs.AGC_EXACT_KW)
            for _ in range(3))
out["exact_cli_chunk"] = {"samples": x.shape[0], "ms": ms,
                          "cycles_a_sample": ms * 1e-3 * 1980e6 / x.shape[0],
                          "probe_cycles_a_sample": probe}
for k, g in zip(("y", "gain", "hang", "peak", "awc"), got):
    ys[f"exact {k}"] = g.cpu().numpy()
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
                       if k not in ys or not np.array_equal(
                           np.atleast_1d(first[k]).view(np.uint8),
                           np.atleast_1d(ys[k]).view(np.uint8))]
    print(json.dumps({"bit_for_bit": not differ, "outputs": list(first),
                      "differ": differ}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
