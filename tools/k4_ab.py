#!/usr/bin/env python3
"""K4 (the fastddc inverse) and paths A and A' on two trees of this
repository, in turns on one GPU:

    git archive <parent> | tar -x -C build/parent     # build/ is git-ignored
    python3 tools/k4_ab.py build/parent .

Each tree's own ``chip_smoke.inv_case`` (K4 at chip_smoke.py's four shapes:
D=16, 4 and 256 at 64 channels x 1024 frames, D=16 at 256 x 512) and
``chip_smoke.throughput`` (path A, the 64-channel D=16 channelizer, and
path A', fastddc_fwd_block | fastddc_inv_block, on three device-resident
chunks) run in a fresh process started in that tree, in the order parent,
change, change, parent.  Prints the card's name and power
limit, then one JSON line per run.  Each tree builds its kernels into its
own build/ directory.
"""

from __future__ import annotations

import json
import subprocess
import sys

RUN = r'''
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from csdr_tpu_torch import Pipeline
from csdr_tpu_torch.ops import fastddc as fd
rates = cs.bench_rates()
out = {}
for d, b, r in ((16, 1024, rates), (4, 1024, rates), (256, 1024, rates),
                (16, 512, np.random.default_rng(0).uniform(-0.4, 0.4, 256))):
    out[f"K4 D={d} C={len(r)} ms"] = cs.inv_case(torch, d, b, r, 13)["ms"]
ddc = fd.fastddc_init(0.05, 16)
chunk = cs.FRAMES_A * ddc.input_size
x = cs.tones(3 * chunk, [0.01], 5)
chan = fd.fastddc_channelizer_block(ddc, rates).to(torch.device("cuda"))
xs = [torch.from_numpy(x[i * chunk:(i + 1) * chunk]).cuda() for i in range(3)]
pipes = {"A": Pipeline([chan], name="A"),
         "A'": Pipeline([fd.fastddc_fwd_block(ddc),
                         fd.fastddc_inv_block(ddc, rates)],
                        name="A'").to(torch.device("cuda"))}
for key, pipe in pipes.items():
    tp = cs.throughput(torch, pipe, xs)
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
    for side in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=trees[side],
                              capture_output=True, text=True, timeout=600)
        found = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode or not found:
            print(proc.stdout[-2000:] + proc.stderr[-2000:], file=sys.stderr)
            return 1
        print(json.dumps({"tree": side, **json.loads(found[-1][7:])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
