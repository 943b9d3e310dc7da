"""Launcher for the native nmux fan-out server (native/nmux.cpp).

    ... | python -m csdr_tpu_torch.server.nmux --port 4952 [--bufsize N] [--bufcnt N]

Builds the C++ binary on first use (make -C native) and exec()s it with
stdin/stdout passed through, so the TCP data path runs entirely native,
as the reference's ``nmux`` (nmux.cpp:60-353).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

NATIVE = Path(__file__).resolve().parent.parent.parent / "native"


def main(argv=None):
    binary = NATIVE / "build" / "nmux"
    if not binary.exists():
        sys.stderr.write("nmux: building native binary...\n")
        subprocess.run(["make", "-C", str(NATIVE)], check=True)
    os.execv(str(binary), ["nmux"] + (argv or sys.argv[1:]))


if __name__ == "__main__":
    main()
