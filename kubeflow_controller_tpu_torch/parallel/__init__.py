"""Parallelism of the port.

- ``mesh`` — ``MeshSpec``, ``build_mesh`` (a ``DeviceMesh`` with every
  canonical axis over the process group's world, one device a process),
  ``data_axes``, ``data_parallel_size``.
- ``sharding`` — the logical-axis rule table, ``logical_to_pspec``, DTensor
  ``placements_for`` and ``with_logical_constraint``.
- ``collectives`` — psum, pmean, all_gather, psum_scatter, axis index and
  size, ring_permute over a mesh axis's process group; over a process
  group, ``permute_group`` (several tensors rotated in one batch,
  returned before the wait) and ``all_to_all_group``.
- ``ring`` — ring attention (dense and flash inners, the per-rank
  schedules and their two transports) and the attention oracle
  (``attention_reference``).
- ``ulysses`` — Ulysses attention: all-to-all to head shards and back.
- ``pipeline`` — pipeline parallelism: ``split_stages``, ``gpipe`` and the
  1F1B schedule ``pipeline_1f1b``, each stage's schedule written once and
  driven over the pp process group (``GroupPipe``) or over virtual stages
  in one process (``Lockstep``).
"""
