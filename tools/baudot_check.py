#!/usr/bin/env python3
"""The RTTY Baudot decoder's kernel (kernels/baudot_cuda, csrc/baudot.cu)
on one GPU: a quick check and its times, the script each step of the
kernel's redesign was measured with.

    python3 tools/baudot_check.py          # checks, times, phases
    python3 tools/baudot_check.py --sass   # also the kernel's SASS counts

Checks, bit for bit (characters, count, state): the kernel and its serial
route (baudot_cuda.decode_serial) against decode_plain on the card on 9
rows of 700 symbols (framed characters, all ones, all zeros, noise; the
carried states include ones a stream never makes) at two caps, on 3 rows
at n of 1, 5, 31, 33, 1001 (the plain loop), 4096 and 9000 (the serial
route), and the segmented route against the serial one at the CLI's
65 536-symbol chunk (a row starting on and off 16-byte alignment) and at
134 rows of it.  Times (utils/timing.time_cuda, queued behind a spin
kernel): the kernel and the serial route at the CLI's chunk, an empty
launch (baudot_cuda.empty_launch), the kernel at 134 x 65 536.  Then the
timed kernel's SM cycles a block-wide step of each tile
(baudot_cuda.phase_cycles) at the chunk, segmented and serial, and at 134
rows.  With --sass: the kernel's SASS (nvcc -cubin, cuobjdump -sass), the
instruction count of each kernel and the block barriers' positions.
Prints the card's name and power limit first; exits non-zero if a check
fails."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import rtty_symbols as rtty  # noqa: E402
from csdr_tpu_torch.kernels import _build, baudot_cuda  # noqa: E402
from csdr_tpu_torch.ops import digital  # noqa: E402
from csdr_tpu_torch.utils.timing import time_cuda  # noqa: E402

CHUNK = 1 << 16


def flat(r) -> tuple:
    return (r[0], r[1], *r[2])


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))


def sass() -> None:
    """The kernel's SASS: instructions a kernel, the barriers' places."""
    nvcc = _build.nvcc_path()
    with tempfile.TemporaryDirectory() as tmp:
        cubin = str(Path(tmp, "b.cubin"))
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-cubin", "-o", cubin,
                        str(_build.CSRC / "baudot.cu")], check=True)
        text = subprocess.run(
            [str(Path(nvcc).parent / "cuobjdump"), "-sass", cubin],
            check=True, capture_output=True, text=True).stdout
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        lines = [ln for ln in fn.split("\n")
                 if re.search(r"/\*[0-9a-f]{4,6}\*/", ln)]
        bars = [i for i, ln in enumerate(lines) if "BAR.SYNC" in ln]
        print("sass", json.dumps({"kernel": fn.split("\n")[0][:120],
                                  "instructions": len(lines),
                                  "barriers_at": bars}))


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print("ptxas", json.dumps(_build.ptxas_usage("baudot.cu")))
    dev = torch.device("cuda")
    tables = digital._baudot_tables(dev)
    ok = True
    rng = np.random.default_rng(1)
    n = 700
    rows = np.stack([rtty(n, s) for s in range(6)] + [
        np.ones(n, np.uint8), np.zeros(n, np.uint8),
        rng.integers(0, 3, n).astype(np.uint8) * 5])
    st = tuple(torch.tensor(v, dtype=torch.int32, device=dev) for v in (
        [0, 1, 2, 0, -1, 7, 0, 2, 2], [0, 0, 1, 0, 5, 0, 1, 0, 5],
        [0, 3, 27, 31, -9, 1 << 20, 27, 5, 3],
        [0, 0, 4, 0, -1, (1 << 31) - 1, 0, 5, -60],
        [0, 1, 0, 1, -3, 0, 1, 1, 1]))
    rb = torch.from_numpy(rows).to(dev)
    for cap in (n // 7 + 4, 7):
        want = baudot_cuda.decode_plain(rb, cap, st, *tables)
        r = (same(baudot_cuda.decode(rb, cap, st, *tables), want),
             same(baudot_cuda.decode_serial(rb, cap, st, *tables), want))
        print("rows of 700, cap", cap, r, flush=True)
        ok &= all(r)
    st3 = tuple(torch.tensor(v, dtype=torch.int32, device=dev) for v in (
        [0, 2, 0], [0, 1, 1], [0, 3, 27], [0, 2, 5], [0, 1, 1]))
    for nn in (1, 5, 31, 33, 1001, 4096, 9000):
        x = torch.from_numpy(rtty(nn, nn)).to(dev)[None].repeat(3, 1)
        x[1, :] = 1
        ser = baudot_cuda.decode_serial(x, nn // 7 + 4, st3, *tables)
        want = baudot_cuda.decode_plain(x, nn // 7 + 4, st3, *tables) \
            if nn <= 1001 else ser
        r = (same(baudot_cuda.decode(x, nn // 7 + 4, st3, *tables), want),
             same(ser, want))
        print("n", nn, r, flush=True)
        ok &= all(r)
    xs = torch.from_numpy(rtty(CHUNK + 7, 3)).to(dev)
    cap = CHUNK // 7 + 4
    z = baudot_cuda.zero_state((), dev)
    for off in (0, 7):
        x = xs[off:off + CHUNK]
        r = same(baudot_cuda.decode(x, cap, z, *tables),
                 baudot_cuda.decode_serial(x, cap, z, *tables))
        print("the chunk at offset", off, "segmented = serial", r,
              flush=True)
        ok &= r
    big = torch.from_numpy(np.stack([rtty(CHUNK, s)
                                     for s in range(134)])).to(dev)
    r = same(baudot_cuda.decode(big, cap, z, *tables),
             baudot_cuda.decode_serial(big, cap, z, *tables))
    print("134 rows segmented = serial", r, flush=True)
    ok &= r
    x = xs[:CHUNK]
    for name, fn in (
            ("kernel", lambda: baudot_cuda.decode(x, cap, z, *tables)),
            ("serial route", lambda: baudot_cuda.decode_serial(
                x, cap, z, *tables)),
            ("empty launch", baudot_cuda.empty_launch),
            ("kernel 134 rows", lambda: baudot_cuda.decode(big, cap, z,
                                                           *tables))):
        print("ms", name, time_cuda(fn, iters=20, queue_ahead_ms=20.0),
              flush=True)
    z1 = tuple(t.reshape(1) for t in z)
    for serial in (False, True):
        for _ in range(2):
            print("phases serial" if serial else "phases",
                  json.dumps(baudot_cuda.phase_cycles(
                      x[None].contiguous(), cap, z1, *tables, serial)),
                  flush=True)
    zb = baudot_cuda.zero_state((134,), dev)
    print("phases 134 rows", json.dumps(baudot_cuda.phase_cycles(
        big, cap, zb, *tables)))
    if "--sass" in sys.argv[1:]:
        sass()
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
