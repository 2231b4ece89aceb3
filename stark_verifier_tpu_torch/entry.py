"""Entry points of the port.

    entry(device="cuda")    -> (fn, example_args): the per-proof Semaphore
                               verifier over the 8 proofs of
                               fixtures/sem_entry8.npz, ready to call as
                               fn(*example_args) -> accept bool [8].
    dryrun_multichip(n)     -> spawns n gloo ranks on the CPU; each verifies
                               its slice of the 2n proofs of
                               fixtures/sem_dryrun3w8.npz through the sharded
                               verifier, and the ranks reduce the accept count
                               and the per-rank digests. At n = 8 the ranks
                               also verify the first 16 zk20 proofs
                               (fixtures/sem_zk20b64.npz) batch-in-lanes.

    python -m stark_verifier_tpu_torch.entry dryrun N   # the dry run, N ranks
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "fixtures"


def entry(device="cuda"):
    """The flagship per-proof verifier on `device` and its example input."""
    from .core.types import load_proofs
    from .models import flagship as FS

    proofs, common, vk = load_proofs(FIXTURES / "sem_entry8.npz")
    fn, to_device = FS.make_verifier_fn(common, vk, device=device)
    return fn, (to_device(FS.batched_arrays(proofs)),)


def _dryrun_leg(mesh, fixture, batch, batched):
    """This rank's part of one leg: verify its slice, reduce; checks that
    every local bit is true and that the count is the batch."""
    from .core.types import load_proofs
    from .models import flagship as FS
    from .parallel.batch_verify import make_sharded_verifier

    proofs, common, vk = load_proofs(fixture)
    shard, verify_fn, agg_fn = make_sharded_verifier(
        common, vk, mesh, device="cpu", batched=batched)
    pa = shard(FS.batched_arrays(proofs[:batch]))
    ok = verify_fn(pa)
    digests, count = agg_fn(pa["public_inputs"], ok)
    assert bool(ok.all()), f"rejected local lanes {(~ok).nonzero().flatten().tolist()}"
    assert count == batch, (count, batch)
    return common, tuple(digests.shape)


def _dryrun_rank(rank: int, world: int, store: str):
    import torch
    import torch.distributed as dist

    from .parallel.mesh import make_mesh
    from .parallel.multihost import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"file://{store}", world, rank, device="cpu")
    try:
        mesh = make_mesh(world)
        _, shape = _dryrun_leg(mesh, FIXTURES / "sem_dryrun3w8.npz", 2 * world, False)
        print(f"DRYRUN[{rank}]: verified {2 * world} proofs, digest shards {shape}",
              flush=True)
        if world == 8:
            common, shape = _dryrun_leg(mesh, FIXTURES / "sem_zk20b64.npz", 16, True)
            print(f"DRYRUN[{rank}]: FLAGSHIP zk20 verified 16 proofs (deg "
                  f"2^{common.degree_bits}, "
                  f"{common.config.fri_config.num_query_rounds} queries, zk), "
                  f"digest shards {shape}", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """The multi-rank verifier on n gloo ranks of this machine's CPU, each a
    process of its own; raises unless every rank passes."""
    if not 1 <= n_devices <= 8:
        raise ValueError("dryrun_multichip: 1 to 8 ranks (16 proofs in the fixture)")
    batch = 2 * n_devices
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "stark_verifier_tpu_torch.entry", "rank",
             str(r), str(n_devices), store],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(REPO)) for r in range(n_devices)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"DRYRUN[{r}]: verified {batch} proofs" not in out:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank {r} failed "
                               f"(exit {p.returncode}):\n{out[-3000:]}")
    print(f"dryrun_multichip({n_devices}): verified {batch} proofs, "
          f"digest shards ({n_devices}, 4)")
    if n_devices == 8:
        print(f"dryrun_multichip({n_devices}): FLAGSHIP zk20 verified 16 proofs")
        print(f"dryrun_multichip({n_devices}): leg=flagship")
    else:
        print(f"dryrun_multichip({n_devices}): leg=tiny")


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:
        _dryrun_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["dryrun"] and len(sys.argv) == 3:
        dryrun_multichip(int(sys.argv[2]))
    else:
        sys.exit(__doc__)
