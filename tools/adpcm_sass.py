#!/usr/bin/env python3
"""What nvcc made of the ADPCM codec (``csdr_tpu_torch/csrc/adpcm.cu``):

    python3 tools/adpcm_sass.py [path/to/adpcm.cu]

Compiles the source alone with the port's flags and ``-Xptxas -v``
(registers, stack frame and spills of every kernel), then reads its SASS
(``cuobjdump -sass``) and, for each loop of the encoder and the decoder
kernel (a backward branch), counts the instructions of its body and the
codec steps it covers: every 32-bit load of the encoder's loop is a pair
of samples, every byte load of the decoder's group loops a pair of
nibbles, so steps = 2 x global loads.  Prints one JSON line per kernel
(the loops with their instructions a step and the body's opcodes) and
exits non-zero if a kernel spills.  Needs nvcc and cuobjdump (the CUDA
toolkit); no GPU.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from csdr_tpu_torch.kernels import _build  # noqa: E402

KERNELS = ("adpcm_encode_kernel", "adpcm_decode_kernel")
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def functions(sass: str) -> dict:
    """Function name -> [(address, instruction text)]."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = SASS_LINE.search(line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    return funcs


def opcode(text: str) -> str:
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def loops(code: list) -> list:
    """Each backward branch's body: instructions, loads, steps, opcodes."""
    found = []
    for addr, text in code:
        if opcode(text) != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", text.split("BRA", 1)[1])
        if not m or int(m.group(1), 16) >= addr:
            continue
        lo = int(m.group(1), 16)
        body = [opcode(t) for a, t in code if lo <= a <= addr
                and opcode(t) != "NOP"]
        loads = sum(1 for op in body if op.startswith("LDG"))
        steps = 2 * loads
        found.append({"from": hex(lo), "to": hex(addr),
                      "instructions": len(body), "global_loads": loads,
                      "steps": steps,
                      "instructions_a_step": (len(body) / steps if steps
                                              else None),
                      "opcodes": dict(collections.Counter(
                          op.split(".")[0] for op in body).most_common())})
    return found


def main() -> int:
    src = Path(sys.argv[1]) if len(sys.argv) > 1 else \
        ROOT / "csdr_tpu_torch" / "csrc" / "adpcm.cu"
    nvcc = _build.nvcc_path()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        obj = str(Path(tmp, "adpcm.o"))
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v",
                               "-c", "-o", obj, str(src)],
                              capture_output=True, text=True, check=True)
        info = _build.parse_ptxas(proc.stdout + proc.stderr)
        sass = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                              text=True, check=True).stdout
    spills = False
    for name, code in functions(sass).items():
        kernel = next((k for k in KERNELS if k in name), None)
        if kernel is None:
            continue
        regs = next((v for k, v in info.items() if kernel in k), {})
        spills |= bool(regs.get("spill_store_bytes") or
                       regs.get("spill_load_bytes"))
        print(json.dumps({"kernel": kernel, "instructions": len(code),
                          **regs, "loops": loops(code)}), flush=True)
    return 1 if spills else 0


if __name__ == "__main__":
    sys.exit(main())
