"""The plonky2-compatible prover: the circuit builder (builder.py), the
batched prover (prove.py) with its LDE backends (lde.py), and the witness
checker (check.py)."""
