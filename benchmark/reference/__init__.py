"""The benchmark's plain reference: the plonky2 verifier in plain PyTorch
ops, a frozen copy of the port's plain path with its imports rewritten and
every kernel dispatch taken out. It reads the fixtures itself and imports
neither the program (stark_verifier_tpu_torch) nor the JAX package."""
