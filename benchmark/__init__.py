"""The benchmark of stark_verifier_tpu_torch (see README.md)."""
