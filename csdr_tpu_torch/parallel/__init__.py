"""Multi-card distribution over torch.distributed (counterpart of
csdr_tpu.parallel; SURVEY.md §2.12-2.13).

The reference's concurrency models, csdr_tpu's mesh equivalents, and the
port's:

- process pipeline over Unix pipes -> one jitted program in csdr_tpu ->
  one process a card here, its blocks called in turn on the card;
- nmux TCP fan-out -> broadcast over mesh axes -> every rank of a chan row
  reads the same wideband shard (``mesh.shard_input``);
- ddcd per-client channels -> channel-axis sharding -> each rank keeps its
  rows of the channels (``mesh.chan_rows``);
- block streaming with overlap -> time-axis sharding and a ``ppermute``
  halo -> a send of each shard's tail to its right neighbour over the
  "time" process group (``halo.halo_from_left``), and the de-emphasis
  carry fixed up from one all-gather (``halo.affine_scan_fixup``);
- the corner turn between channelizer and modem (a resharding constraint
  in csdr_tpu) -> an all-gather of the decimated channel streams over the
  "time" group (``models.multichannel``).

The mesh is a ``DeviceMesh`` of shape (chan, time), one rank a shard
(``mesh.init_mesh``, ``mesh.run_mesh``); every collective counts its bytes
in ``utils.collectives``.  On a card a rank's step is csdr_tpu's jitted
step as CUDA graphs: one between each two collectives, which run eagerly
between the replays, and one in all where time is 1
(``segments.SegmentedStep``).
"""
