#!/usr/bin/env python3
"""K3 (the kernel-order FFT pair) and paths B and C on two trees of this
repository, in turns on one GPU:

    git archive <parent> | tar -x -C build/parent     # build/ is git-ignored
    python3 tools/k3_ab.py build/parent .

Each tree's own ``chip_smoke.fft_case`` (K3 at chip_smoke.py's shapes:
fft_ko at N=1024 x 3200 frames, path B's, and fft_ko and ifft_ko at N=256 x
270 frames, paths C's and E's, plus ifft_ko at N=1024 x 3200) and
``chip_smoke.throughput`` (path B, the D=50 fastddc forward in kernel order
and the classed inverse, and path C, ssb_receiver(agc_on=False), each on
three device-resident chunks) run in a fresh process started in that
tree, in the order parent, change, change, parent.  Prints the card's name
and power limit, then one JSON line per run.  Each tree builds its kernels
into its own build/ directory.
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
from csdr_tpu_torch.models import receivers
from csdr_tpu_torch.ops import fastddc as fd
out = {}
frames_c = cs.CHUNK_C // 8900
for name, n, b in (("fft_ko", 1024, cs.FRAMES_B), ("fft_ko", 256, frames_c),
                   ("ifft_ko", 256, frames_c), ("ifft_ko", 1024, cs.FRAMES_B)):
    c = cs.fft_case(torch, name, n, b, 11)
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "snr_db"):
        out[f"{name} N={n} {k}"] = c[k]
dev = torch.device("cuda")
ddc = fd.fastddc_init(0.05, 50)
chunk = cs.FRAMES_B * ddc.input_size
x = cs.tones(3 * chunk, [0.01], 6)
pipe_b = Pipeline([fd.fastddc_fwd_block(ddc, spectra_order="kernel"),
                   fd.fastddc_inv_block(ddc, cs.bench_rates(),
                                        spectra_order="kernel")],
                  name="B").to(dev)
xb = [torch.from_numpy(x[i * chunk:(i + 1) * chunk]).to(dev)
      for i in range(3)]
s = np.arange(3 * cs.CHUNK_C, dtype=np.float64)
xc = np.exp(2j * np.pi * np.mod(0.0005 * s, 1.0)).astype(np.complex64)
pipe_c = receivers.ssb_receiver(0.0, 0.1, 0.05, decimation=50,
                                agc_on=False).to(dev)
xcs = [torch.from_numpy(xc[i * cs.CHUNK_C:(i + 1) * cs.CHUNK_C]).to(dev)
       for i in range(3)]
for key, pipe, xs in (("B", pipe_b, xb), ("C", pipe_c, xcs)):
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
