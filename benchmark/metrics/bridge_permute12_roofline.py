"""bridge_permute12_roofline (layer: hash; moves verified_proofs_per_s): the
least time of a batch's BN254 bridge permutations over the device time of
the bridge kernel a batch, in the traced stretch; counted as
poseidon_permute_roofline is. Read where the transcript hasher is "bn254"."""
from benchmark.harness import yardstick

UNIT = "%"
KERNELS = r"bridge_permute12\w*_kernel"


def read(run):
    perms = run.per_proof.get("bn254")
    if run.trace is None or run.config.get("hasher") != "bn254" or not perms:
        return None
    t = run.trace.device_s(KERNELS) / run.trace.batches
    if t <= 0:
        return None
    return 100.0 * perms * run.batch * yardstick.BRIDGE_PERMUTATION_S / t
