"""Witness constraint checker, the MockProver analogue: evaluates every
gate's constraints on the witness rows and the copy constraints, and
reports each violation with its row, gate and constraint, in the JAX
package's words and order.

The rows of one gate type are evaluated together, one lane a row, over
`rings.BaseRing` on the circuit's device; the copy classes are compared on
the host.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.rings import BaseRing
from ..ops import gl64
from ..ops import poseidon_gl as pg
from .builder import CircuitData


def _tensor(F, x):
    return x.to(F.device) if torch.is_tensor(x) else F.from_u64(x)


def check_witness(data: CircuitData, W, pis, batch_index: int = 0) -> List[str]:
    """W: [num_wires, n, B], pis: [num_pis, B] (int64 tensors, or numpy
    uint64 arrays); returns a list of violation descriptions for witness
    `batch_index`."""
    F = gl64.Field(data.device)
    W = _tensor(F, W)[:, :, batch_index]  # [nw, n]
    pis = _tensor(F, pis)[:, batch_index]
    pi_hash = pg.hash_no_pad(F, list(pis))

    rows_by_gate = {}
    for row, (gate, consts) in enumerate(data.builder.gate_rows):
        rows_by_gate.setdefault(gate.id, (gate, []))[1].append((row, consts))
    found = []  # (row, constraint, gate id)
    for gid, (gate, rows) in rows_by_gate.items():
        idx = torch.tensor([r for r, _ in rows], device=F.device)
        width = max(len(c) for _, c in rows) + 8
        consts = np.zeros((width, len(rows)), dtype=np.uint64)
        for k, (_, c) in enumerate(rows):
            consts[:len(c), k] = [v % gl64.P for v in c]
        R = BaseRing(F, (len(rows),))
        cs = gate.eval_unfiltered(R, list(F.from_u64(consts)),
                                  list(W[:, idx]), pi_hash)
        if not cs:
            continue
        bad = ~F.is_zero(torch.stack(torch.broadcast_tensors(*cs, R.zero())[:-1]))
        for j, k in torch.nonzero(bad).tolist():
            found.append((rows[k][0], j, gid))
    out = [f"row {row} gate {gid} constraint {j} != 0" for row, j, gid in sorted(found)]

    # copy constraints (transitive classes)
    parent = {}

    def find(t):
        while parent.get(t, t) != t:
            parent[t] = parent.get(parent[t], parent[t])
            t = parent[t]
        return t

    for a, b in data.builder.copy_constraints:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    classes = {}
    for a, b in data.builder.copy_constraints:
        for t in (a, b):
            if t[0] == "w":
                classes.setdefault(find(t), []).append(t)
    values = F.to_u64(W)
    for root, members in classes.items():
        if len({int(values[t[2], t[1]]) for t in members}) > 1:
            out.append(f"copy class {root}: differing values over {members[:4]}...")
    return out
