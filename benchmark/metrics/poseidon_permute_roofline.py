"""poseidon_permute_roofline (layer: hash; moves verified_proofs_per_s): the
least time of a batch's Goldilocks Poseidon permutations over the device
time of the Poseidon kernels a batch, in the traced stretch. The
permutations are counted from the reference's own calls (a proof's lanes
times B), each at the frozen least time of harness/yardstick.py. Read
where the configuration's transcript hasher is Goldilocks Poseidon."""
from benchmark.harness import yardstick

UNIT = "%"
KERNELS = r"poseidon_permute\w*_kernel"


def read(run):
    perms = run.per_proof.get("poseidon")
    if run.trace is None or run.config.get("hasher") != "poseidon" or not perms:
        return None
    t = run.trace.device_s(KERNELS) / run.trace.batches
    if t <= 0:
        return None
    return 100.0 * perms * run.batch * yardstick.GL_PERMUTATION_S / t
