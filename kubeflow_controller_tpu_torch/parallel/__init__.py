"""Parallelism of the port.  So far only the attention oracle
(``ring.attention_reference``); meshes, sharding, ring and Ulysses
attention come later (ROADMAP.md)."""
