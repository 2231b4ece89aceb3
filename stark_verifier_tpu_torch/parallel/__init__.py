"""Proof-batch data parallelism over ranks: one process a card (NCCL) or a
CPU process (gloo), a one-dimensional `DeviceMesh` over the world, each rank
verifying its contiguous slice of the batch, the accept count and the
per-rank digests reduced by collectives."""
