"""Every command of tests/test_cli_smoke.py's CASES through csdr_tpu's
``main`` and the port's (``--device cpu``), in this process, on the same
stdin: the same exit code, the same stderr lines, and the same stdout at
the bars of test_torch_cli.py (bytes and integers bit for bit, floats at
100 dB, Costas at 32/28 dB, awgn_cc by its statistics there).  Text
outputs are compared as text; shift_addition_cc_test's error vectors, two
float32 NCOs against float64, within 0.5 dB, and the port adds its
timing lines on stderr."""

import re
import sys
from pathlib import Path

import pytest

from test_cli_smoke import CASES, SKIP
from test_torch_cli import assert_outputs_match, run_both

# commands whose output cannot be compared sample for sample
BY_STATISTICS = {"awgn_cc"}       # test_torch_cli.test_awgn_cc_statistics


def test_chip_smoke_sweep_is_this_sweep():
    """chip_smoke.py's path X'' rebuilds CASES without importing csdr_tpu:
    the same commands, arguments, stdin bytes and expectations, and the
    same float formats as test_torch_cli's."""
    import test_torch_cli
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    assert chip_smoke.sweep_cases() == CASES
    assert chip_smoke.SWEEP_F32 == test_torch_cli.F32_OUT
    assert chip_smoke.SWEEP_C64 | {"fastddc_inv_cc"} == test_torch_cli.C64_OUT


def test_sweep_covers_the_registry():
    from csdr_tpu_torch import cli
    names = sorted(n for n in cli.REGISTRY if not n.startswith("-"))
    assert [n for n in names if n not in CASES and n not in SKIP] == []


@pytest.mark.parametrize("name", sorted(set(CASES) - BY_STATISTICS))
def test_cli_matches_csdr_tpu(name):
    args, inp, expect_out = CASES[name]
    (rj, oj, ej), (rt, ot, et) = run_both(name, args, inp)
    assert rj == rt == 0, (name, et[-400:])
    if expect_out:
        assert len(ot) > 0, name
    if name == "shift_addition_cc_test":
        lines_j, lines_t = oj.decode().splitlines(), ot.decode().splitlines()
        assert len(lines_t) == len(lines_j) == 2
        num = re.compile(r"-?\d+\.\d+ dB")
        for a, b in zip(lines_j, lines_t):
            assert num.sub("", a) == num.sub("", b)
            va, vb = (float(num.search(v).group()[:-3]) for v in (a, b))
            assert abs(va - vb) < 0.5 and vb < -100, (a, b)
        assert et.startswith(ej)
        return
    if name == "--help":
        # the usage text names the port, line for line the same commands
        assert len(et.splitlines()) == len(ej.splitlines()) + 1
        return
    assert_outputs_match(name, oj, ot)
    assert et == ej, (name, ej[-300:], et[-300:])
