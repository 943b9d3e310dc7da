#!/usr/bin/env python3
"""The chunked AGC's relaxation kernel (csrc/agc.cu) and agc_ff's exact
scan (csrc/agc_exact.cu) on two trees of this repository, in turns on one
GPU:

    git archive <parent> | tar -x -C build/parent     # build/ is git-ignored
    python3 tools/agc_ab.py build/parent .

Each tree runs in a fresh process started in that tree, in the order
parent, change, change, parent, with its own kernels (each tree builds
into its own build/ directory).  In each, ``agc_cuda.relax`` on the
inputs below, timed as chip_smoke.agc_case times it (time_cuda, 20 calls
queued ahead):

- ``E`` and ``F``: paths E's and F's second audio chunk (48 060 and
  48 000 samples, six rows), continuing from their first chunk's state on
  the card (chip_smoke.pre_agc_audio);
- ``agc_signal``: ``agc_signal()`` from the stream's start, seven rows,
  the last of which never settles;
- ``134_rows``: E's chunk tiled over 134 rows, past what either tree
  holds on an H100 at once (rows in turns).

A tree whose ``agc_cuda`` has ``CLUSTER_MAX`` runs each case at a most
of 8 and of 16 CTAs a cluster (the latter keyed ``*_k16``, its outputs
bit for bit the former's), each with its cluster plan
(``agc_cuda.plan``).  Each case reports the scans on the chain
(per outer round the most of any row) and the kernel's ms a scan on it;
``probe_scan_cycles`` is the tree's own bound probe
(``agc_cuda.scan_cycles``, the least of three).  Then ``agc_cuda.scan``
on the CLI's chunk as chip_smoke.agc_exact_case times it (65 536 samples
of chip_smoke.agc_exact_input, AGC_EXACT_KW, continuing from gain 1.5 and
peak 0.133 on the card), with its SM cycles a sample at 1980 MHz and the
chain probe's (``agc_cuda.exact_cycles``, the least of three).  Every
output (y, gain, hang, converged; y and the four state values of the
exact scan) must equal the first run's bit for bit.  Prints the card's
name and power limit, one JSON line per run, then the bit-for-bit
verdict; exits non-zero if a run fails or an output differs.
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
from csdr_tpu_torch.models import receivers
from csdr_tpu_torch.utils.timing import time_cuda
from test_torch_agc_kernel import agc_signal
import chip_smoke as cs
dump = sys.argv[1]
dev = torch.device("cuda")
s = np.arange(2 * cs.CHUNK_C, dtype=np.float64)
xe = np.exp(2j * np.pi * np.mod(0.0005 * s, 1.0)).astype(np.complex64)
e, e_kw = cs.pre_agc_audio(torch, lambda: receivers.ssb_receiver(
    0.0, 0.1, 0.05, decimation=50), xe, cs.CHUNK_C)
t = np.arange(2 * cs.CHUNK) / cs.FS
xa = (1.0 + 0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.complex64)
f, f_kw = cs.pre_agc_audio(torch, receivers.am_receiver, xa, cs.CHUNK)
cases = {"E": (e, e_kw), "F": (f, f_kw), "agc_signal": (agc_signal(), {}),
         "134_rows": (np.tile(e, -(-134 * 8192 // len(e)))[:134 * 8192 - 100],
                      e_kw)}
mosts = (8, 16) if hasattr(agc_cuda, "CLUSTER_MAX") else (None,)
out, ys = {}, {}
for most in mosts:
    if most is not None:
        agc_cuda.CLUSTER_MAX = most
    for name, (x, kw) in cases.items():
        key = name if most in (None, 8) else f"{name}_k{most}"
        a = torch.from_numpy(x).to(dev)
        *got, table = agc_cuda.relax(a, rounds=True, **kw)
        ms = time_cuda(lambda: agc_cuda.relax(a, **kw), iters=20,
                       queue_ahead_ms=20.0)
        rounds, settled = table.cpu().numpy()
        chain = int((rounds - settled).max(1).sum())
        out[key] = {"samples": len(x), "rows": rounds.shape[1],
                    "scans_on_chain": chain, "ms": ms,
                    "ms_a_scan": ms / chain}
        if most is not None:
            out[key]["cluster"] = agc_cuda.plan(len(x))
        for k, g in zip(("y", "gain", "hang", "converged"), got):
            g = g.cpu().numpy()
            if f"{name} {k}" in ys and not np.array_equal(
                    np.atleast_1d(g).view(np.uint8),
                    np.atleast_1d(ys[f"{name} {k}"]).view(np.uint8)):
                raise SystemExit(f"{key} {k}: differs from the 8-CTA run")
            ys[f"{name} {k}"] = g
out["probe_scan_cycles"] = min(agc_cuda.scan_cycles(100) for _ in range(3))
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
