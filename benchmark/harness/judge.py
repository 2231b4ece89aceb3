"""How `correct` is decided: every lane of every batch the program answered
against the plain reference's accept bit for that lane.

The reference verifies each distinct lane of the pool once (the honest
proofs and each corrupted variant); a batch's expected bits are those of
its lanes. The number compared is `mismatched_lanes`, with the limit 0:
the accept bit is exact, and a lane the program answered wrongly, or a
batch it answered with another shape, counts against it.
"""
from __future__ import annotations

import numpy as np

LIMITS = {"mismatched_lanes": 0}


class YardstickBroken(RuntimeError):
    """The reference accepted a corrupted lane or rejected an honest one:
    the comparison could no longer tell a verifier that accepts everything
    from a sound one, so the run gives no result."""


def check_reference(ref_bits, n_honest: int):
    """The reference must accept every honest proof and reject every
    corrupted variant."""
    ref_bits = np.asarray(ref_bits, dtype=bool)
    rejected = np.flatnonzero(~ref_bits[:n_honest])
    accepted = np.flatnonzero(ref_bits[n_honest:]) + n_honest
    if len(rejected) or len(accepted):
        raise YardstickBroken(f"the reference rejected honest lanes {rejected.tolist()} "
                              f"and accepted corrupted lanes {accepted.tolist()}")


def compare(answers, ref_lane, ref_bits) -> dict:
    """`answers`: (pool batch j, bits answered) pairs; `ref_lane[j]` the
    reference lane of each lane of batch j. Returns the numbers compared,
    each with its limit, and the lanes judged."""
    ref_bits = np.asarray(ref_bits, dtype=bool)
    mismatched = attempted = 0
    for j, bits in answers:
        want = ref_bits[ref_lane[j]]
        attempted += len(want)
        bits = np.asarray(bits)
        if bits.shape != want.shape or bits.dtype != np.bool_:
            mismatched += len(want)
        else:
            mismatched += int(np.count_nonzero(bits != want))
    return {"attempted": attempted,
            "checks": {"mismatched_lanes": {"value": mismatched,
                                            "limit": LIMITS["mismatched_lanes"]}}}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
