#!/usr/bin/env python3
"""chip_smoke.py's bank paths G and G' and then its sharded banks (M, M',
M'': each bank captured and eager, in the same rank on the same chunks),
alone, on one card:

    python3 tools/mesh_phase.py

The mesh phase spawns its ranks, which import this file again as their
main module: the work sits under ``if __name__ == "__main__"``."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_phase: CUDA is not available", file=sys.stderr)
        return 2
    from csdr_tpu_torch.kernels import _build

    cs.phase_env(torch, _build)
    banks = {"G": cs.bank_path(torch, "G", 50, cs.FRAMES_G, cs.CHUNKS_G,
                               "fft_ko"),
             "G'": cs.bank_path(torch, "G'", 16, cs.FRAMES_GP, cs.CHUNKS_GP,
                                "fastddc_inv")}
    cs.phase_mesh_paths(torch, banks)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
