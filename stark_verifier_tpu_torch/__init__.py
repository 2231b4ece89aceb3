"""stark_verifier_tpu_torch: the PyTorch/CUDA port of the JAX package beside it.

A batched verifier and prover for plonky2/FRI proofs over the Goldilocks
field, and the Semaphore access set, for an NVIDIA Hopper GPU. Same
sub-layout and module names as the JAX package (`ops/`, `core/`, `models/`,
`parallel/`, `prover/`, `semaphore/`, `utils/`); it imports `torch` and
`numpy` only.
Entry points take an explicit `device` and default to "cuda".
"""
