#!/usr/bin/env python3
"""The IMA ADPCM codec kernels and paths W and W1 on two trees of this
repository, in turns on one GPU:

    git archive <parent> | tar -x -C build/parent     # build/ is git-ignored
    python3 tools/adpcm_ab.py build/parent .

Each tree runs in a fresh process started in that tree, in the order
parent, change, change, parent, with its own ``chip_smoke`` helpers and
kernels (each tree builds into its own build/ directory):

- the codec at the four shapes of PERF.md's codec table, on the inputs
  chip_smoke.py gives them: encode the 9 s16 rows of W's first waterfall
  chunk (9 x 4106) and W1's 48 000-sample audio chunk (1 x 48 000), decode
  W1's bytes (1 x 48 000 nibbles) and the 9 rows' bytes (9 x 4106), each
  timed as chip_smoke.adpcm_case times it (time_cuda, 20 calls queued
  ahead), with SM cycles a step at 1980 MHz and the share of its bound:
  chip_smoke's chain bound (the encoder's steps x the probe's shortest
  step chain, the decoder's 2 x ceil(log2 steps) scan levels, each in SM
  cycles from this run's probe), which at these shapes is larger than the
  bytes' and the integer operations' time, so it is chip_smoke's bound_ms;
- paths W and W1 by chip_smoke.throughput on three device-resident chunks
  (step ms as launched, device-only ms, busy share).

Every output of a run (the codec's bytes, samples and states at the four
shapes, W's and W1's outputs over three chunks) must equal the first
run's bit for bit.  Prints the card's name and power limit, one JSON line
per run, then the bit-for-bit verdict; exits non-zero if a run fails or
an output differs.
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
sys.path.insert(0, ".")
import chip_smoke as cs
from csdr_tpu_torch.kernels import adpcm_cuda
from csdr_tpu_torch.ops import adpcm
from csdr_tpu_torch.utils.timing import time_cuda
dump = sys.argv[1]
dev = torch.device("cuda")
out, ys = {}, {}
chains = cs.adpcm_chains(torch)
out["probe"] = chains
pipe = cs.waterfall_chain().to(dev)
with torch.no_grad():
    _, outs = cs.drive_blocks(pipe, pipe.init(dev),
                              torch.from_numpy(cs.waterfall_u8(0)).to(dev))
s16 = adpcm.compress_fft_s16(outs[3]).contiguous()
gen = np.random.default_rng(42)
t = np.arange(2 * cs.AUDIO_RATE) / cs.AUDIO_RATE
gen.uniform(-130, -20, (4, cs.W_FFT))      # chip_smoke's edge rows come first
audio = 0.5 * np.sin(2 * np.pi * 1000 * t) + 0.01 * gen.standard_normal(len(t))
a16 = torch.from_numpy(np.round(audio * 32767).astype(np.int16)).to(dev)
x1 = a16[None, :cs.AUDIO_RATE].contiguous()
cases = {}
for key, x in (("W", s16), ("W1", x1)):
    st = torch.zeros((x.shape[0], 2), dtype=torch.int32, device=dev)
    y, sy = adpcm_cuda.encode(x, st)
    cases["encode " + key] = (adpcm_cuda.encode, x, st, x.shape[1], y, sy)
    d, sd = adpcm_cuda.decode(y, st)
    cases["decode " + key] = (adpcm_cuda.decode, y, st, 2 * y.shape[1], d, sd)
for name, (fn, x, st, steps, y, sy) in cases.items():
    ms = time_cuda(lambda: fn(x, st), iters=20, queue_ahead_ms=20.0)
    if name.startswith("encode"):
        bound = steps * chains["encode_step_cycles"] / cs.SM_CLOCK_HZ * 1e3
    else:
        levels = 2 * int(np.ceil(np.log2(steps)))
        bound = levels * chains["scan_level_cycles"] / cs.SM_CLOCK_HZ * 1e3
    out[name] = {"rows": x.shape[0], "steps": steps, "ms": ms,
                 "cycles_a_step": ms * 1e-3 * cs.SM_CLOCK_HZ / steps,
                 "bound_ms": bound, "share": bound / ms}
    ys[name] = y.cpu().numpy()
    ys[name + " state"] = sy.cpu().numpy()
# paths W and W1: three device-resident chunks each
w_u8 = [torch.from_numpy(cs.waterfall_u8(c)).to(dev) for c in range(3)]
b = cs.config1_u8(3 * cs.W1_CHUNK)
w1_u8 = [torch.from_numpy(b[2 * c * cs.W1_CHUNK: 2 * (c + 1) * cs.W1_CHUNK]
                          ).to(dev) for c in range(3)]
for key, make, xs in (("W", cs.waterfall_chain, w_u8),
                      ("W1", cs.config1_chain, w1_u8)):
    p = make().to(dev)
    state, got = p.init(dev), []
    with torch.no_grad():
        for xc in xs:
            state, y = p(state, xc)
            got.append(y.compact() if hasattr(y, "compact") else y)
    ys["path " + key] = torch.cat(got).cpu().numpy()
    tp = cs.throughput(torch, p, xs)
    out["path " + key] = {k: tp[k] for k in ("step_ms", "device_ms",
                                             "device_busy_share")}
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
                       if k not in ys or not np.array_equal(first[k], ys[k])]
    print(json.dumps({"bit_for_bit": not differ, "outputs": list(first),
                      "differ": differ}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
