#!/usr/bin/env python3
"""BASELINE config 5 (paths G and G') on two trees of this repository, in
turns on one GPU, each step timed the same ways on both:

    git archive <parent> | tar -x -C build/parent     # build/ is git-ignored
    python3 tools/ted_ab.py build/parent .

Each tree runs in a fresh process started in that tree, in the order
parent, change, change, parent, with its own ``chip_smoke`` helpers and
kernels.  G (D=50, 3200 frames a chunk) and G' (D=16, 1024 frames) are
built and fed as chip_smoke.bank_path builds and feeds them (bank_plan,
bank_input), three chunks each; then, on the first chunk, from the state
after it:

- step_ms: 3 back-to-back steps between CUDA events as issued, median of
  3 (chip_smoke.bank_cost's step_ms), and the Msps of input it gives;
- queued_ms: the same window queued behind a spin kernel 4x as long as
  its issue, so the events time the device alone (where a step issues
  more launches than the launch queue holds, as the parent's ~9 900 do,
  the host waits on the queue and this reads about step_ms);
- profiler_ms: the union of the kernels' intervals in one step under
  torch.profiler (chip_smoke.profile_call, bank_cost's device_ms), with
  its launch calls and device kernels; the busy shares of both device
  times in step_ms;
- where the tree has the TED kernel (kernels/ted_cuda): its device ms in
  each of 5 profiled steps, and its bound: the most alive slots of any
  lane in that step x the probe's slot chain (chip_smoke.ted_chains) at
  1980 MHz, with the share of it.

Before the banks, where the tree has the TED kernel, the kernel alone on
chip_smoke.phase_ted_kernels's inputs (chip_smoke.ted_inputs, seeds 51
and 52): G's shape (64 lanes) and segmented (64 x TED_SEGMENTS lanes),
timed as chip_smoke.ted_case times it, with its SM cycles a slot and its
share of the same bound; its outputs are compared like the paths'.

Every path's bits and counts over its three chunks must equal the first
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
from csdr_tpu_torch.models import multichannel
from csdr_tpu_torch.utils.timing import time_cuda
try:
    from csdr_tpu_torch.kernels import ted_cuda
except ImportError:
    ted_cuda = None
from torch.profiler import ProfilerActivity, profile
dump = sys.argv[1]
dev = torch.device("cuda")
out, ys = {}, {}
chains = cs.ted_chains(torch) if ted_cuda else None
out["probe"] = chains
if ted_cuda:
    m = cs.FRAMES_G // 25 * 448
    params = ted_cuda.TedParams(cs.SPS, (3 * cs.SPS // 2, cs.SPS // 2,
                                         cs.SPS), True, True, 2.0, 0.5)
    for name, segs, seed in (("alone", 1, 51),
                             ("alone segmented", cs.TED_SEGMENTS, 52)):
        planes, size, bs, corr, cap, hi, lo = cs.ted_inputs(
            torch, cs.CHANNELS, m, cs.SPS, segs, seed)

        def run():
            return ted_cuda.scan(planes, size, bs, corr, cap, hi, lo,
                                 params=params)

        got = run()
        ms = time_cuda(run, iters=20, queue_ahead_ms=20.0)
        lanes = bs.numel()
        st = torch.cat([got[4].reshape(lanes, cap),
                        got[0].reshape(lanes, 1)], 1)
        slots = int((st[:, 1:] != st[:, :-1]).sum(1).max())
        bound = slots * chains["slot_cycles"] / cs.SM_CLOCK_HZ * 1e3
        out[name] = {"lanes": lanes, "alive_slots_most": slots, "ms": ms,
                     "cycles_a_slot": ms * 1e-3 * cs.SM_CLOCK_HZ / slots,
                     "bound_ms": bound, "share": bound / ms}
        for i, t in enumerate(got):
            ys[f"{name} {i}"] = t.cpu().numpy()
rates, bpsk, centres = cs.bank_plan()
for key, decim, frames in (("G", 50, cs.FRAMES_G), ("G'", 16, cs.FRAMES_GP)):
    init, step, meta = multichannel.build_ddc_bpsk31_bank(
        rates, decim, cs.SPS, device=dev)
    chunk = frames * meta["input_size"]
    _, x = cs.bank_input(torch, decim, 3 * chunk, centres, 40 + decim)
    xs = [x[c * chunk:(c + 1) * chunk] for c in range(3)]
    with torch.no_grad():
        outs = cs.drive_bank(torch, step, init(chunk), xs)
    for c, (b, k) in enumerate(outs):
        ys[f"{key} bits {c}"] = b.cpu().numpy()
        ys[f"{key} counts {c}"] = k.cpu().numpy()
    box = {"state": init(chunk)}

    def one_step():
        box["state"], o = step(box["state"], xs[0])
        return o

    res = {"chunk": chunk}
    with torch.no_grad():
        one_step()
        res["step_ms"] = time_cuda(one_step, iters=3, warmup=1, repeats=3)
        spin = max(100.0, 4 * 3 * res["step_ms"])
        res["queued_spin_ms"] = spin
        res["queued_ms"] = time_cuda(one_step, iters=3, warmup=1, repeats=3,
                                     queue_ahead_ms=spin)
        prof = cs.profile_call(torch, one_step)
        res["profiler_ms"] = prof["device_ms"]
        res["msps"] = chunk / res["step_ms"] / 1e3
        res["profiler_busy_share"] = res["profiler_ms"] / res["step_ms"]
        res["queued_busy_share"] = res["queued_ms"] / res["step_ms"]
        res["launch_calls"] = prof["cuda_launch_calls"]
        res["device_kernels"] = prof["device_kernels"]
        if ted_cuda:
            seen, scan = [], ted_cuda.scan

            def record(*a, **kw):
                r = scan(*a, **kw)
                seen.append(r)
                return r

            ted_cuda.scan = record
            one_step()
            ted_cuda.scan = scan
            bs, starts = seen[-1][0], seen[-1][4]
            lanes, cap = bs.numel(), starts.shape[-1]
            st = torch.cat([starts.reshape(lanes, cap),
                            bs.reshape(lanes, 1)], 1)
            slots = int((st[:, 1:] != st[:, :-1]).sum(1).max())
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                for _ in range(5):
                    one_step()
                torch.cuda.synchronize()
            ted = [(e.time_range.end - e.time_range.start) / 1e3
                   for e in p.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and ("ted_scan_kernel" in e.name
                        or "ted_ring_kernel" in e.name)]
            bound = slots * chains["slot_cycles"] / cs.SM_CLOCK_HZ * 1e3
            res["ted_in_step"] = {
                "lanes": lanes, "slots": cap, "alive_slots_most": slots,
                "kernel_ms": ted, "bound_ms": bound,
                "share": [bound / t for t in ted]}
    out[key] = res
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
