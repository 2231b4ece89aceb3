"""models/flagship.build_semaphore_batch at a set of 2^16 keys, the size
from which it may cache the hashed keys and tree: with neither a
`cache_tag` nor a `cache_dir` it reads and writes nothing (the repo's
fixtures/ stays as it was); with a `cache_dir` the tree lands there, and
the proofs are the same under the same random draws. The batch is one
signal at the small preset, to keep the file under a minute here."""

from stark_verifier_tpu_torch.models import flagship as TFS
from test_torch_prover import assert_proofs_equal, port_accepts, port_rngs

BITS = 16


def _listing():
    return sorted(p.name for p in TFS.FIXTURE_DIR.iterdir())


def test_semaphore_batch_at_16_bits_caches_only_where_asked(tmp_path):
    before = _listing()
    uncached, common, vk = TFS.build_semaphore_batch(BITS, 1, cache_tag=None,
                                                     device="cpu", **port_rngs())
    assert _listing() == before
    assert port_accepts(common, vk, uncached)
    cached, _, _ = TFS.build_semaphore_batch(BITS, 1, cache_tag=None, device="cpu",
                                             cache_dir=tmp_path, **port_rngs())
    assert [p.name for p in tmp_path.iterdir()] == [f"aset_tree_{BITS}_0.npz"]
    assert _listing() == before
    assert_proofs_equal(uncached, cached)
