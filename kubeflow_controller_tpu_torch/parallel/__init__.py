"""Parallelism of the port.

- ``mesh`` — ``MeshSpec``, ``build_mesh`` (a ``DeviceMesh`` with every
  canonical axis over the process group's world, one device a process),
  ``data_axes``, ``data_parallel_size``.
- ``sharding`` — the logical-axis rule table, ``logical_to_pspec``, DTensor
  ``placements_for`` and ``with_logical_constraint``.
- ``collectives`` — psum, pmean, all_gather, psum_scatter, axis index and
  size, ring_permute over a mesh axis's process group.
- ``ring`` — the attention oracle (``attention_reference``); ring and
  Ulysses attention come later (ROADMAP.md, M3).
"""
