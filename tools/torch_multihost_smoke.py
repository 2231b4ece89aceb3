"""One rank of a multi-process proof verification on the CPU (gloo).

    python tools/torch_multihost_smoke.py <rank> <world> <init_file>

Start one process a rank, all with the same `init_file` (a path that does
not exist yet: the ranks meet through a file store there). The batch is the
16 proofs of fixtures/sem_dryrun3w8.npz with proof 5 corrupted; each rank
converts only its own slice (`host_batch_slice`), verifies it proof by
proof, and the ranks reduce the accept count and the per-rank digests. Each
rank checks its accept bits, the count (15) and every rank's digest against
a replay of the digest chain on the host, and prints
`MULTIHOST_VERIFY[rank]: PASS count=15 world=<world>`.
"""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
B = 16
BAD = 5


def main(rank: int, world: int, init_file: str):
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    import torch.distributed as dist

    from stark_verifier_tpu_torch.core.types import load_proofs
    from stark_verifier_tpu_torch.models import flagship as FS
    from stark_verifier_tpu_torch.ops import gl64
    from stark_verifier_tpu_torch.ops import poseidon_gl as pg
    from stark_verifier_tpu_torch.parallel.batch_verify import make_batch_verifier
    from stark_verifier_tpu_torch.parallel.mesh import make_mesh
    from stark_verifier_tpu_torch.parallel.multihost import (
        host_batch_slice, init_distributed)

    torch.set_num_threads(1)
    assert init_distributed(f"file://{init_file}", world, rank, device="cpu")
    try:
        mesh = make_mesh()
        proofs, common, vk = load_proofs(REPO / "fixtures" / "sem_dryrun3w8.npz")
        batched = FS.batched_arrays(proofs[:B])
        batched["open_wires"][BAD, 2, 0] ^= np.uint64(1)
        lo, hi = host_batch_slice(B)
        F = gl64.Field("cpu")
        # this rank converts only its own rows
        pa = {k: F.from_u64(v[lo:hi]) for k, v in batched.items()}
        ok, digests, count = make_batch_verifier(common, vk, mesh, device="cpu")(pa)
        want = [b != BAD for b in range(lo, hi)]
        assert ok.tolist() == want, (rank, ok.tolist(), want)
        assert count == B - 1, count
        assert tuple(digests.shape) == (world, 4), digests.shape
        # host replay of every rank's chain, plain permutation, python loop
        pis = batched["public_inputs"]
        for r in range(world):
            acc = [0, 0, 0, 0]
            for b in range(*host_batch_slice(B, r, world)):
                row = [int(x) for x in pis[b]] + [int(b != BAD)] + acc
                out = pg.hash_no_pad(F, [F.const(x) for x in row],
                                     permute=pg.permute_plain)
                acc = [int(F.to_u64(x)) for x in out]
            got = [int(x) for x in F.to_u64(digests[r])]
            assert got == acc, (rank, r, got, acc)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"MULTIHOST_VERIFY[{rank}]: PASS count={B - 1} world={world}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 4:
        sys.exit(__doc__)
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
