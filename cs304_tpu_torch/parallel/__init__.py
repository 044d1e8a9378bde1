"""Data parallelism over ranks: the device mesh, sharded E-steps and decodes,
and the fixed-order collectives."""
