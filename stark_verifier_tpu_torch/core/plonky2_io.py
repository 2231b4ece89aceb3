"""plonky2's proof wire formats: serde JSON and the compact bytes.

Host numpy, no tensors. `proof_to_json` / `proof_from_json` write and read
the JSON shape plonky2's serde derives give `ProofWithPublicInputs<F, C, 2>`:

  ProofWithPublicInputs { proof, public_inputs: [u64] }
  Proof { wires_cap, plonk_zs_partial_products_cap, quotient_polys_cap,
          openings, opening_proof }
  MerkleCap        -> [ {"elements": [u64;4]}, ... ]        (newtype Vec)
  HashOut          -> {"elements": [u64;4]}
  QuadraticExtension -> [u64, u64]                          (newtype [F;2])
  OpeningSet { constants, plonk_sigmas, wires, plonk_zs, plonk_zs_next,
               partial_products, quotient_polys }
  FriProof { commit_phase_merkle_caps, query_round_proofs,
             final_poly: {"coeffs": [[u64,u64]]}, pow_witness: u64 }
  FriQueryRound { initial_trees_proof: {"evals_proofs":
                    [[[u64], {"siblings": [HashOut]}], ...]},
                  steps: [{"evals": [[u64,u64]],
                           "merkle_proof": {"siblings": [HashOut]}}] }

`proof_to_bytes` / `proof_from_bytes` write and read the byte layout of
`ProofWithPublicInputs::to_bytes` / `from_bytes(bytes, common_data)`
(described below). Both directions round-trip bit-exactly.
"""
from __future__ import annotations

import json
import struct
from typing import List

import numpy as np

from .types import CommonData, FriProof, FriQueryRounds, OpeningSet, Proof


def _hashout(arr4) -> dict:
    return {"elements": [int(x) for x in arr4]}

def _cap(cap) -> list:
    return [_hashout(cap[r]) for r in range(cap.shape[0])]

def _exts(arr) -> list:
    """[n, 2] -> [[u64, u64], ...]"""
    return [[int(e[0]), int(e[1])] for e in arr]


def proof_to_json(proof: Proof) -> str:
    op = proof.opening_proof
    qr = op.query_rounds
    Q = qr.initial_evals[0].shape[0]
    rounds = []
    for q in range(Q):
        evals_proofs = []
        for o in range(4):
            evals_proofs.append([
                [int(x) for x in qr.initial_evals[o][q]],
                {"siblings": [_hashout(h) for h in qr.initial_siblings[o][q]]},
            ])
        steps = []
        for li in range(len(qr.step_evals)):
            steps.append({
                "evals": _exts(qr.step_evals[li][q]),
                "merkle_proof": {
                    "siblings": [_hashout(h) for h in qr.step_siblings[li][q]]
                },
            })
        rounds.append({
            "initial_trees_proof": {"evals_proofs": evals_proofs},
            "steps": steps,
        })
    obj = {
        "proof": {
            "wires_cap": _cap(proof.wires_cap),
            "plonk_zs_partial_products_cap": _cap(proof.plonk_zs_partial_products_cap),
            "quotient_polys_cap": _cap(proof.quotient_polys_cap),
            "openings": {
                "constants": _exts(proof.openings.constants),
                "plonk_sigmas": _exts(proof.openings.plonk_sigmas),
                "wires": _exts(proof.openings.wires),
                "plonk_zs": _exts(proof.openings.plonk_zs),
                "plonk_zs_next": _exts(proof.openings.plonk_zs_next),
                "partial_products": _exts(proof.openings.partial_products),
                "quotient_polys": _exts(proof.openings.quotient_polys),
            },
            "opening_proof": {
                "commit_phase_merkle_caps": [
                    _cap(op.commit_phase_caps[i])
                    for i in range(op.commit_phase_caps.shape[0])
                ],
                "query_round_proofs": rounds,
                "final_poly": {"coeffs": _exts(op.final_poly)},
                "pow_witness": int(op.pow_witness),
            },
        },
        "public_inputs": [int(x) for x in proof.public_inputs],
    }
    return json.dumps(obj)


# --------------------------------------------------------------------------
# plonky2 COMPACT BINARY format (util/serialization Buffer layout)
#
# This is the byte format `ProofWithPublicInputs::to_bytes` /
# `::from_bytes(bytes, common_data)` produce and consume in the plonky2
# crate the reference pins (Cargo.toml:11) — the shape external proof bytes
# actually arrive in. Layout (all field elements canonical u64
# little-endian, lengths NOT serialized except the one u8 below — the
# reader derives every count from CommonData, exactly as plonky2's
# `read_proof(common_data)` does):
#
#   proof_with_public_inputs := proof || field_vec(public_inputs)
#   proof      := cap(wires) || cap(zs_partial_products) || cap(quotient)
#                 || opening_set || fri_proof
#   cap        := hash[2^cap_height]           hash := 4 x u64le (HashOut)
#   opening_set:= ext_vec(constants) || ext_vec(plonk_sigmas)
#                 || ext_vec(wires) || ext_vec(plonk_zs)
#                 || ext_vec(plonk_zs_next) || ext_vec(partial_products)
#                 || ext_vec(quotient_polys)  ext := 2 x u64le (D = 2)
#   fri_proof  := cap[num_reduction_layers] || query_round[num_query_rounds]
#                 || ext_vec(final_poly) || u64le(pow_witness)
#   query_round:= initial_trees || step[num_reduction_layers]
#   initial_trees := (field_vec(leaf_o) || merkle_proof)  for o in 4 oracles
#                    (leaf_o length = oracle num_polys + salt)
#   step       := ext_vec(evals[arity]) || merkle_proof
#   merkle_proof := u8(num_siblings) || hash[num_siblings]
#                    (the ONE length plonky2 does serialize:
#                     serialization/mod.rs write_merkle_proof)
# --------------------------------------------------------------------------


class _Buf:
    """Sequential reader over bytes, mirroring plonky2's Buffer."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _need(self, n_bytes: int):
        if self.pos + n_bytes > len(self.data):
            raise ValueError(
                f"proof bytes end at {len(self.data)}, {n_bytes} more needed at "
                f"{self.pos}: common data does not match this proof")

    def fields(self, n: int) -> np.ndarray:
        """n canonical u64le field elements -> uint64[n]."""
        self._need(8 * n)
        out = np.frombuffer(self.data, dtype="<u8", count=n, offset=self.pos)
        self.pos += 8 * n
        return out.astype(np.uint64)

    def exts(self, n: int) -> np.ndarray:
        """n quadratic-extension elements -> uint64[n, 2]."""
        return self.fields(2 * n).reshape(n, 2)

    def hashes(self, n: int) -> np.ndarray:
        """n HashOuts -> uint64[n, 4]."""
        return self.fields(4 * n).reshape(n, 4)

    def u8(self) -> int:
        self._need(1)
        v = self.data[self.pos]
        self.pos += 1
        return v


def _w_fields(out: bytearray, arr):
    out += np.ascontiguousarray(
        np.asarray(arr, dtype=np.uint64).reshape(-1)).astype("<u8").tobytes()


def proof_to_bytes(proof: Proof) -> bytes:
    """plonky2 `ProofWithPublicInputs::to_bytes` byte layout (see above)."""
    out = bytearray()
    _w_fields(out, proof.wires_cap)
    _w_fields(out, proof.plonk_zs_partial_products_cap)
    _w_fields(out, proof.quotient_polys_cap)
    o = proof.openings
    for a in (o.constants, o.plonk_sigmas, o.wires, o.plonk_zs,
              o.plonk_zs_next, o.partial_products, o.quotient_polys):
        _w_fields(out, a)
    op = proof.opening_proof
    _w_fields(out, op.commit_phase_caps)
    qr = op.query_rounds
    Q = qr.initial_evals[0].shape[0]
    n_steps = len(qr.step_evals)
    for q in range(Q):
        for orc in range(4):
            _w_fields(out, qr.initial_evals[orc][q])
            sibs = qr.initial_siblings[orc][q]
            out += struct.pack("<B", sibs.shape[0])
            _w_fields(out, sibs)
        for li in range(n_steps):
            _w_fields(out, qr.step_evals[li][q])
            sibs = qr.step_siblings[li][q]
            out += struct.pack("<B", sibs.shape[0])
            _w_fields(out, sibs)
    _w_fields(out, op.final_poly)
    _w_fields(out, np.asarray(op.pow_witness).reshape(1))
    _w_fields(out, proof.public_inputs)
    return bytes(out)


def proof_from_bytes(data: bytes, common: CommonData) -> Proof:
    """plonky2 `ProofWithPublicInputs::from_bytes(bytes, common_data)`:
    every count below is derived from CommonData the same way plonky2's
    `read_proof` derives it (serialization/mod.rs)."""
    b = _Buf(data)
    cap_size = 1 << common.config.fri_config.cap_height
    wires_cap = b.hashes(cap_size)
    zs_pp_cap = b.hashes(cap_size)
    quot_cap = b.hashes(cap_size)
    cfg = common.config
    openings = OpeningSet(
        constants=b.exts(common.num_constants),
        plonk_sigmas=b.exts(cfg.num_routed_wires),
        wires=b.exts(cfg.num_wires),
        plonk_zs=b.exts(cfg.num_challenges),
        plonk_zs_next=b.exts(cfg.num_challenges),
        partial_products=b.exts(cfg.num_challenges * common.num_partial_products),
        quotient_polys=b.exts(cfg.num_challenges * common.quotient_degree_factor),
    )
    arity_bits = common.fri_params.reduction_arity_bits
    n_layers = len(arity_bits)
    commit_phase_caps = (b.hashes(n_layers * cap_size).reshape(
        n_layers, cap_size, 4) if n_layers else np.zeros((0, cap_size, 4),
                                                         np.uint64))
    Q = cfg.fri_config.num_query_rounds
    leaf_lens = [n + common.salt_size(blinding)
                 for n, blinding in common.fri_oracles()]
    init_evals = [[] for _ in range(4)]
    init_sibs = [[] for _ in range(4)]
    step_evals = [[] for _ in range(n_layers)]
    step_sibs = [[] for _ in range(n_layers)]
    for _ in range(Q):
        for orc in range(4):
            init_evals[orc].append(b.fields(leaf_lens[orc]))
            init_sibs[orc].append(b.hashes(b.u8()))
        for li in range(n_layers):
            step_evals[li].append(b.exts(1 << arity_bits[li]))
            step_sibs[li].append(b.hashes(b.u8()))
    final_poly = b.exts(common.fri_params.final_poly_len)
    pow_witness = b.fields(1)[0]
    public_inputs = b.fields(common.num_public_inputs)
    if b.pos != len(data):
        raise ValueError(
            f"trailing bytes: consumed {b.pos} of {len(data)} — "
            "common data does not match this proof")
    return Proof(
        wires_cap=wires_cap,
        plonk_zs_partial_products_cap=zs_pp_cap,
        quotient_polys_cap=quot_cap,
        openings=openings,
        opening_proof=FriProof(
            commit_phase_caps=commit_phase_caps,
            query_rounds=FriQueryRounds(
                initial_evals=[np.stack(e) for e in init_evals],
                initial_siblings=[np.stack(s) for s in init_sibs],
                step_evals=[np.stack(e) for e in step_evals],
                step_siblings=[np.stack(s) for s in step_sibs],
            ),
            final_poly=final_poly,
            pow_witness=np.uint64(pow_witness),
        ),
        public_inputs=public_inputs,
    )


def _np_cap(lst) -> np.ndarray:
    if not lst:
        return np.zeros((0, 4), np.uint64)
    return np.array([h["elements"] for h in lst], dtype=np.uint64)

def _np_exts(lst) -> np.ndarray:
    if not lst:
        return np.zeros((0, 2), np.uint64)
    return np.array(lst, dtype=np.uint64)


def proof_from_json(s: str) -> Proof:
    d = json.loads(s)
    p = d["proof"]
    op = p["opening_proof"]
    rounds = op["query_round_proofs"]
    n_oracles = len(rounds[0]["initial_trees_proof"]["evals_proofs"])
    assert n_oracles == 4, n_oracles
    n_steps = len(rounds[0]["steps"])
    init_evals: List[np.ndarray] = []
    init_sibs: List[np.ndarray] = []
    for o in range(4):
        init_evals.append(np.array(
            [r["initial_trees_proof"]["evals_proofs"][o][0] for r in rounds],
            dtype=np.uint64))
        init_sibs.append(np.stack([
            _np_cap(r["initial_trees_proof"]["evals_proofs"][o][1]["siblings"])
            for r in rounds
        ]))
    step_evals, step_sibs = [], []
    for li in range(n_steps):
        step_evals.append(np.stack(
            [_np_exts(r["steps"][li]["evals"]) for r in rounds]))
        step_sibs.append(np.stack(
            [_np_cap(r["steps"][li]["merkle_proof"]["siblings"]) for r in rounds]))
    cpc = op["commit_phase_merkle_caps"]
    return Proof(
        wires_cap=_np_cap(p["wires_cap"]),
        plonk_zs_partial_products_cap=_np_cap(p["plonk_zs_partial_products_cap"]),
        quotient_polys_cap=_np_cap(p["quotient_polys_cap"]),
        openings=OpeningSet(
            constants=_np_exts(p["openings"]["constants"]),
            plonk_sigmas=_np_exts(p["openings"]["plonk_sigmas"]),
            wires=_np_exts(p["openings"]["wires"]),
            plonk_zs=_np_exts(p["openings"]["plonk_zs"]),
            plonk_zs_next=_np_exts(p["openings"]["plonk_zs_next"]),
            partial_products=_np_exts(p["openings"]["partial_products"]),
            quotient_polys=_np_exts(p["openings"]["quotient_polys"]),
        ),
        opening_proof=FriProof(
            commit_phase_caps=(np.stack([_np_cap(c) for c in cpc])
                               if cpc else np.zeros((0, 1, 4), np.uint64)),
            query_rounds=FriQueryRounds(
                initial_evals=init_evals,
                initial_siblings=init_sibs,
                step_evals=step_evals,
                step_siblings=step_sibs,
            ),
            final_poly=_np_exts(op["final_poly"]["coeffs"]),
            pow_witness=np.uint64(op["pow_witness"]),
        ),
        public_inputs=np.array(d["public_inputs"], dtype=np.uint64),
    )
