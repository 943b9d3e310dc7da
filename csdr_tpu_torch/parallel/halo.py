"""Halo exchange and the cross-shard scan fixup for time-sharded streams
(counterpart of csdr_tpu.parallel.halo).

The reference keeps taps_length-1 samples of history per block
(csdr.c:1164-1176) and carries IIR state in structs.  With the time axis
sharded over ranks these become:

- FIR history -> a halo: each time shard receives the last ``halo``
  samples of its left neighbour, zeros on shard 0 (the single-card
  stream's zero history).  csdr_tpu sends it around a ``ppermute`` ring;
  here each shard but the last sends its tail to its right neighbour with
  ``batch_isend_irecv`` on the mesh's "time" group, so the bytes moved are
  the halo's and no more.
- 1-pole IIR carry -> every shard's local affine reduction (B, A), with
  y_out = B*y_in + A, gathered over the time group (one small
  all-gather), then the exclusive prefix computed locally: the carry
  entering this shard.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from csdr_tpu_torch.parallel.mesh import all_gather
from csdr_tpu_torch.utils import collectives


def halo_from_left(x: torch.Tensor, halo: int, mesh) -> torch.Tensor:
    """The last ``halo`` samples (along the last axis) of the left time
    neighbour's ``x``, zeros on time shard 0.  Counted under "halo"."""
    p, t = mesh.shape["time"], mesh.coords["time"]
    if not 0 < halo <= x.shape[-1]:
        raise ValueError(f"halo {halo} for a shard of {x.shape[-1]} "
                         "samples")
    recv = x.new_zeros(x.shape[:-1] + (halo,))
    if p == 1:
        return recv
    c = mesh.coords["chan"]
    group = mesh.group("time")
    sent = recv.numel() * recv.element_size() if t + 1 < p else 0
    with collectives.counted("halo", sent):
        ops = []
        if t + 1 < p:
            ops.append(dist.P2POp(dist.isend, mesh.to_wire(x[..., -halo:]),
                                  mesh.rank_at(c, t + 1), group))
        if t > 0:
            wire_in = mesh.to_wire(recv)
            ops.append(dist.P2POp(dist.irecv, wire_in,
                                  mesh.rank_at(c, t - 1), group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if t > 0:
            recv = mesh.from_wire(wire_in, recv)
    return recv


def concat_with_left_halo(x: torch.Tensor, halo: int, mesh) -> torch.Tensor:
    """[left neighbour's tail | local shard]: the sharded form of the
    streaming blocks' ``cat([tail, x])``."""
    return torch.cat([halo_from_left(x, halo, mesh), x], -1)


def affine_scan_fixup(b_total: torch.Tensor, a_total: torch.Tensor, y0,
                      mesh) -> torch.Tensor:
    """The carry entering this time shard of the affine recurrence
    y_out = B*y_in + A, from every shard's local reduction ``(b_total,
    a_total)`` (float32, one per independent scan, e.g. per channel) and
    the global initial carry ``y0``: one all-gather of the P pairs over
    the time group (counted under "fixup"), then
    carry <- b_i*carry + a_i for the shards i left of this one."""
    pairs = torch.stack([b_total, a_total])
    if mesh.shape["time"] > 1:
        parts = all_gather(pairs, mesh, "time", "fixup")
    else:
        parts = [pairs]
    carry = torch.full_like(a_total, float(y0))
    for i in range(mesh.coords["time"]):
        carry = parts[i][0] * carry + parts[i][1]
    return carry
