"""What torch.distributed takes from several ranks on one card.

    python3 tools/comm_probe.py

The sharded banks' one-card mode (chip_smoke.py's path M') rests on two
facts, checked here with two ranks on ``cuda:0``:

- ``nccl_two_ranks_one_card``: NCCL refuses two ranks on one device (an
  all_reduce of a CUDA tensor);
- ``gloo_all_gather_cuda``, ``gloo_send_recv_cuda``: whether gloo's
  all_gather and send/recv take CUDA tensors (what the port's host
  staging, ``parallel.mesh.Mesh.staged``, stands in for);
- ``gloo_all_gather_host``: the staged form, host tensors, for contrast.

Each case runs in a subprocess of its own under a time limit, so one that
crashes or hangs is reported as such and ends nothing else.  Prints one
JSON line a case (``ok``, or the error's type and first line, or the
exit code or time-out) and exits 0 once every case has reported; 2
without a card.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CASES = ("nccl_two_ranks_one_card", "gloo_all_gather_cuda",
         "gloo_send_recv_cuda", "gloo_all_gather_host")
TIMEOUT_S = 120


def _rank(rank: int, case: str, port: int, out) -> None:
    import torch
    import torch.distributed as dist

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE="2")
    torch.cuda.set_device(0)
    backend = "nccl" if case.startswith("nccl") else "gloo"
    dist.init_process_group(backend)
    dev = "cpu" if case.endswith("host") else "cuda"
    t = torch.full((4,), float(rank + 1), device=dev)
    try:
        if case == "nccl_two_ranks_one_card":
            dist.all_reduce(t)
            got = t.cpu().tolist()
            want = [3.0] * 4
        elif case.startswith("gloo_all_gather"):
            parts = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(parts, t)
            got = torch.cat(parts).cpu().tolist()
            want = [1.0] * 4 + [2.0] * 4
        else:
            if rank == 0:
                dist.send(t, 1)
                got = want = None
            else:
                dist.recv(t, 0)
                got, want = t.cpu().tolist(), [1.0] * 4
        if rank == 1 or case != "gloo_send_recv_cuda":
            out.put({"case": case, "rank": rank, "result": "ok",
                     "values_right": got == want})
    except Exception as e:  # noqa: BLE001 - the error is the finding
        out.put({"case": case, "rank": rank,
                 "result": f"{type(e).__name__}: "
                           f"{str(e).strip().splitlines()[0][:200]}"})
    finally:
        dist.destroy_process_group()


def run_case(case: str) -> None:
    import torch.multiprocessing as mp

    from csdr_tpu_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    mp.start_processes(_rank, args=(case, free_port(), out), nprocs=2,
                       start_method="spawn")
    seen = []
    while not out.empty():
        seen.append(out.get())
    print(json.dumps(seen[0] if seen else {"case": case,
                                           "result": "no rank reported"}))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--case":
        run_case(sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("comm_probe: needs a CUDA card", file=sys.stderr)
        return 2
    for case in CASES:
        # its own process group, so a time-out ends the ranks too
        p = subprocess.Popen([sys.executable, __file__, "--case", case],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, start_new_session=True)
        try:
            out, err = p.communicate(timeout=TIMEOUT_S)
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            rec = json.loads(lines[-1]) if lines else {
                "case": case, "result": f"exit code {p.returncode}",
                "stderr_tail": err.strip().splitlines()[-3:]}
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
            rec = {"case": case, "result": f"timed out after {TIMEOUT_S} s"}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
