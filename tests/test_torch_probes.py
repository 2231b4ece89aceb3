"""stark_verifier_tpu_torch.ops.probes on the CPU: the plain PyTorch versions
of the two rate probes (what the Hopper kernels are held against on the card,
and what the wrappers run for a CPU tensor) against a restatement in numpy.

The TPU probes themselves cannot serve as the reference here: their chain
bodies are closures inside `tools/vpu_microbench.py:main`, so they cannot be
imported, and its `pallas_call` has no interpret switch, so it cannot run
without the chip. The numpy restatements below follow those bodies line by
line (y*x, y+x, (y>>1)+x, y+(y<x), y*x+x, u32(f32(y))+x) in fixed-width
numpy types, which wrap as the hardware does. Integer ops are compared
exactly; the float32 multiply-add at rtol 1e-5.
"""
import numpy as np
import pytest
import torch

from stark_verifier_tpu_torch.ops import probes

CHAIN = 96


def _np_step(op, y, x):
    if op in ("mul_u32", "mul_lo_u64"):
        return y * x
    if op == "add_u32":
        return y + x
    if op == "shift_add_u32":
        return (y >> np.uint32(1)) + x
    if op == "cmp_add_u32":
        return y + (y < x).astype(np.uint32)
    if op == "fma_f32":
        return y * x + x
    if op == "cvt_u32_f32":
        f = y.astype(np.float32)
        back = np.minimum(f.astype(np.float64), 2.0**32 - 1).astype(np.uint32)
        return back + x
    if op == "mul_hi_u64":
        prod = y.astype(object) * x.astype(object)
        return np.array([int(p) >> 64 for p in prod], dtype=np.uint64)
    if op == "mad_wide_u32":
        return (y & np.uint64(0xFFFFFFFF)) * x.astype(np.uint64) + y
    raise AssertionError(op)


def _np_probe(op, x_t, chain, ilp):
    _, x_dtype, out_dtype = probes.OPS[op]
    unsigned = {torch.int32: np.uint32, torch.int64: np.uint64,
                torch.float32: np.float32}
    x = x_t.numpy().view(unsigned[x_dtype])
    y_type = unsigned[out_dtype]
    total = None
    with np.errstate(over="ignore"):
        for k in range(ilp):
            if op == "fma_f32":
                y = x + np.float32(0.125 * k)
            else:
                y = x.astype(y_type) + y_type(k)
            for _ in range(chain):
                y = _np_step(op, y, x)
            total = y if total is None else total + y
    return total


@pytest.mark.parametrize("ilp", [1, 4])
@pytest.mark.parametrize("op", list(probes.OPS))
def test_alu_plain_matches_numpy(op, ilp):
    rng = np.random.default_rng(len(op) * 10 + ilp)
    x = probes.alu_input(op, 257, rng, "cpu")
    got = probes.alu_plain(x, op, CHAIN, ilp)
    want = _np_probe(op, x, CHAIN, ilp)
    assert got.dtype == probes.OPS[op][2] and got.shape == x.shape
    if op == "fma_f32":
        # numpy rounds y*x and +x apart as the plain version does, but may
        # sum the four chains in another association; and the kernel this
        # stands beside fuses the two. x < 1 makes y -> y*x + x a
        # contraction, so a rounding difference shrinks along the chain
        # instead of growing: 1e-5 relative is generous.
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    else:
        unsigned = np.uint32 if got.dtype == torch.int32 else np.uint64
        assert (got.numpy().view(unsigned) == want).all()
        assert (got != 0).any()  # the chain did not collapse to zero


def test_alu_edge_operands():
    """0, 1 and all-ones operands through every integer op."""
    for op, (_, dtype, _) in probes.OPS.items():
        if dtype == torch.float32:
            continue
        x = torch.tensor([0, 1, -1, 2**31 - 1, -2**31], dtype=dtype)
        if op == "cvt_u32_f32":
            x = torch.tensor([0, 1, 2**16 - 1, 2**24 + 1, 2**31 - 1], dtype=dtype)
        got = probes.alu_plain(x, op, 33, 4)
        unsigned = np.uint32 if got.dtype == torch.int32 else np.uint64
        assert (got.numpy().view(unsigned) == _np_probe(op, x, 33, 4)).all(), op


@pytest.mark.parametrize("op", list(probes.OPS))
def test_alu_wrapper_takes_plain_version_on_cpu_and_counts_no_launch(op):
    rng = np.random.default_rng(3)
    x = probes.alu_input(op, 64, rng, "cpu")
    before = dict(probes.LAUNCHES)
    got = probes.alu_probe(x, op, chain=17, ilp=4)
    assert probes.LAUNCHES == before
    assert torch.equal(got, probes.alu_plain(x, op, 17, 4))
    # no step: the operand itself (zero-extended where the result is wider)
    same = x if op != "mad_wide_u32" else x.to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(probes.alu_probe(x, op, chain=0), same)


@pytest.mark.parametrize("bad", ["op", "dtype", "ilp", "chain"])
def test_alu_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.ones(8, dtype=torch.int32)
    if bad == "op":
        with pytest.raises(ValueError, match="unknown op"):
            probes.alu_probe(x, "div_u32")
    elif bad == "dtype":
        with pytest.raises(TypeError, match="int64"):
            probes.alu_probe(x, "mul_lo_u64")
    elif bad == "ilp":
        with pytest.raises(ValueError, match="ilp"):
            probes.alu_probe(x, "mul_u32", ilp=2)
    else:
        with pytest.raises(ValueError, match="chain"):
            probes.alu_probe(x, "mul_u32", chain=-1)


def _mma_inputs(seed, cols):
    rng = np.random.default_rng(seed)
    M = rng.integers(0, 64, (12, 12), dtype=np.uint8)
    y = rng.integers(0, 256, (12, cols), dtype=np.uint8)
    M[0, :] = 63        # the largest sums the probe allows
    y[:, 0] = 255
    return M, y


@pytest.mark.parametrize("kind", list(probes.KINDS))
def test_mma_probe_matches_numpy(kind):
    """Both kinds compute one function; on the CPU both take the plain
    version, which is compared exactly with an integer matmul in numpy."""
    M, y = _mma_inputs(9, probes.MMA_BLOCK_COLS)
    want = y.astype(np.int64)
    for _ in range(30):
        want = (M.astype(np.int64) @ want) % 256
        assert want.max() < 256
    before = dict(probes.LAUNCHES)
    got = probes.mma_probe(torch.from_numpy(y), torch.from_numpy(M), kind)
    assert probes.LAUNCHES == before
    assert got.dtype == torch.uint8 and (got.numpy() == want).all()
    # one step, so that the unreduced sums are seen too: below 2^18
    assert (M.astype(np.int64) @ y.astype(np.int64)).max() < 2**18
    one = probes.mma_plain(torch.from_numpy(y), torch.from_numpy(M), steps=1)
    assert (one.numpy() == (M.astype(np.int64) @ y.astype(np.int64)) % 256).all()


@pytest.mark.parametrize("bad", ["kind", "dtype", "shape", "columns"])
def test_mma_wrapper_rejects_what_the_kernel_does_not_take(bad):
    M, y = _mma_inputs(1, probes.MMA_BLOCK_COLS)
    M, y = torch.from_numpy(M), torch.from_numpy(y)
    if bad == "kind":
        with pytest.raises(ValueError, match="kind"):
            probes.mma_probe(y, M, "bf16")
    elif bad == "dtype":
        with pytest.raises(TypeError):
            probes.mma_probe(y.to(torch.int32), M)
    elif bad == "shape":
        with pytest.raises(ValueError, match="expected"):
            probes.mma_probe(y[:8], M)
    else:
        with pytest.raises(ValueError, match="multiple"):
            probes.mma_probe(y[:, :100], M)


# The kernel's fragment plan (csrc/probes.cu, above mma_probe_kernel),
# restated in Python.
def _k_rows(kind):
    """The row of y that depth slot k (0..15) of mma_probe's A operand
    carries (csrc/probes.cu takes the product transposed, y^T M^T, with y^T
    as A): the permutation the kernel applies to A's depth and B's alike. u8: slot
    4q + i carries row 2q + (i & 1) + 8 (i >> 1); tf32: slot 8h + q carries
    8h + 2q and slot 8h + q + 4 carries 8h + 2q + 1. Rows 12..15 are zero."""
    if kind == "u8":
        return [2 * (k // 4) + (k % 4 & 1) + 8 * (k % 4 >> 1) for k in range(16)]
    return [8 * (k // 8) + 2 * (k % 4) + (k % 8) // 4 for k in range(16)]


def _fragment_plan(kind):
    """Where the kernel takes each slot of a thread's next A fragment from:
    plan[t][slot] = (source thread, n tile, D element). Slots: u8, register
    r (0, 1) byte i -> 4r + i; tf32, k tile h register e -> 4h + e. The
    source is always the thread itself: with the depth order of _k_rows,
    the D -> A step needs no shuffle."""
    plan = []
    for t in range(32):
        if kind == "u8":
            plan.append([(t, i >> 1, 2 * r + (i & 1)) for r in range(2) for i in range(4)])
        else:
            plan.append([(t, h, 2 * (e & 1) + (e >> 1)) for h in range(2) for e in range(4)])
    return plan


# PTX's fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16" with
# .u8 and "... mma.m16n8k8" with .tf32), thread t, group g = t // 4, q = t % 4
def _ptx_a(kind, t, slot):
    """(m, k) of A held by thread t in a slot of _fragment_plan's order."""
    g, q = divmod(t, 4)
    if kind == "u8":                      # register r, byte i
        r, i = divmod(slot, 4)
        return g + 8 * r, 4 * q + i
    h, e = divmod(slot, 4)                # k tile h, register e
    return g + 8 * (e & 1), 8 * h + q + 4 * (e >> 1)


def _ptx_d(t, e):
    """(m, n) of D (one n8 tile) held by thread t in register e."""
    g, q = divmod(t, 4)
    return g + 8 * (e >> 1), 2 * q + (e & 1)


def _emulate_mma_probe(kind, y, M, steps):
    """The kernel's data flow for one 16-column tile, thread by thread: A
    fragments loaded by _k_rows, the tensor core's product through PTX's
    layouts, the next A taken by _fragment_plan (mod 256)."""
    krow = _k_rows(kind)
    plan = _fragment_plan(kind)
    yp = np.zeros((16, 16), np.int64)
    yp[:12] = y
    Mp = np.zeros((16, 16), np.int64)
    Mp[:12, :12] = M
    frag = [[yp[krow[k], m] for m, k in (_ptx_a(kind, t, s) for s in range(8))]
            for t in range(32)]
    # B = M^T with its depth permuted as A's, one n8 tile each of y's rows
    # 0..7 and 8..15
    B = [np.array([[Mp[8 * j + n, krow[k]] for n in range(8)] for k in range(16)])
         for j in range(2)]
    for _ in range(steps):
        A = np.full((16, 16), -1, np.int64)
        for t in range(32):
            for s in range(8):
                A[_ptx_a(kind, t, s)] = frag[t][s]
        assert (A >= 0).all()             # every element of A in one slot
        D = [A @ B[j] for j in range(2)]
        dfrag = [[[D[j][_ptx_d(t, e)] for e in range(4)] for j in range(2)]
                 for t in range(32)]
        frag = [[dfrag[src][j][e] % 256 for src, j, e in plan[t]] for t in range(32)]
    out = np.zeros((16, 16), np.int64)
    for t in range(32):
        for s in range(8):
            m, k = _ptx_a(kind, t, s)
            out[krow[k], m] = frag[t][s]
    assert not out[12:].any()             # the padding rows stay zero
    return out[:12]


@pytest.mark.parametrize("kind", list(probes.KINDS))
def test_mma_fragment_plan_chains_the_products_in_registers(kind):
    """_k_rows is a permutation of y's 16 (padded) rows, every thread's
    next A fragment comes from its own D fragment (no shuffle), each D
    element feeds exactly one A slot, and the 30 chained products through
    that plan equal mma_plain, column by column. Exact equality."""
    krow = _k_rows(kind)
    assert sorted(krow) == list(range(16))
    plan = _fragment_plan(kind)
    assert all(src == t for t in range(32) for src, _, _ in plan[t])
    assert all(sorted((j, e) for _, j, e in plan[t]) ==
               [(j, e) for j in range(2) for e in range(4)] for t in range(32))
    M, y = _mma_inputs(11, 32)
    want = probes.mma_plain(torch.from_numpy(y), torch.from_numpy(M)).numpy()
    for c in (0, 16):
        got = _emulate_mma_probe(kind, y[:, c:c + 16].astype(np.int64),
                                 M.astype(np.int64), 30)
        assert (got == want[:, c:c + 16]).all()


# ---- what a step of a chain loop executes, counted from cuobjdump's listing
# Short listings in cuobjdump -sass's form: a chain loop of one
# IMAD.WIDE.U32 a step with the 64-bit y as its addend (ilp 1, two steps a
# pass, the factor x in an even register beside the even low word of y;
# ilp 4, one step of each chain a pass, x odd), and the split the assembler
# made of the same step before (four steps of one chain a pass: a product
# with RZ as its addend, the low add, and one high add for two steps).
_SASS_ONE_WIDE_ILP1 = """
	code for sm_90a
		Function : _Z16alu_probe_kernelILi8ELi1EEvPKN4StepIXT_EE1XEPNS1_1YExi
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe20000000800 */
        /*0080*/                   IMAD.WIDE.U32 R2, R4, R2, R2 ;         /* 0x0000000004027225 */
        /*0090*/                   VIADD R6, R6, 0x2 ;
        /*00a0*/                   IMAD.WIDE.U32 R2, R4.reuse, R2, R2 ;
        /*00b0*/                   ISETP.NE.AND P0, PT, R6, R7, PT ;
        /*00c0*/              @P0 BRA 0x80 ;
        /*00d0*/                   STG.E.64 desc[UR4][R4.64], R2 ;
        /*00e0*/                   EXIT ;
        /*00f0*/                   BRA 0xf0;
"""
_SASS_ONE_WIDE_ILP4 = """
		Function : _Z16alu_probe_kernelILi8ELi4EEvPKN4StepIXT_EE1XEPNS1_1YExi
        /*0080*/                   IMAD.WIDE.U32 R2, R5, R2, R2 ;
        /*0090*/                   IMAD.WIDE.U32 R8, R5, R8, R8 ;
        /*00a0*/                   IADD3 R6, R6, 0x1, RZ ;
        /*00b0*/                   IMAD.WIDE.U32 R10, R5, R10, R10 ;
        /*00c0*/                   ISETP.GE.AND P0, PT, R6, UR4, PT ;
        /*00d0*/                   IMAD.WIDE.U32 R12, R5, R12, R12 ;
        /*00e0*/             @!P0 BRA 0x80 ;
        /*00f0*/                   EXIT ;
"""
_SASS_SPLIT_ILP1 = """
		Function : _Z16alu_probe_kernelILi8ELi1EEvPKN4StepIXT_EE1XEPNS1_1YExi
        /*0100*/                   IMAD.WIDE.U32 R8, R2, R0, RZ ;
        /*0110*/                   IADD3 R2, P0, R8, R2, RZ ;
        /*0120*/                   IMAD.WIDE.U32 R10, R2, R0, RZ ;
        /*0130*/                   IADD3 R2, P1, R10, R2, RZ ;
        /*0140*/                   IADD3.X R3, R3, R9, R11, P0, P1 ;
        /*0150*/                   IMAD.WIDE.U32 R8, R2, R0, RZ ;
        /*0160*/                   IADD3 R2, P0, R8, R2, RZ ;
        /*0170*/                   IMAD.WIDE.U32 R10, R2, R0, RZ ;
        /*0180*/                   IADD3 R2, P1, R10, R2, RZ ;
        /*0190*/                   IADD3.X R3, R3, R9, R11, P0, P1 ;
        /*01a0*/                   IADD3 R6, R6, -0x4, RZ ;
        /*01b0*/                   ISETP.NE.AND P2, PT, R6, RZ, PT ;
        /*01c0*/               @P2 BRA 0x100 ;
        /*01d0*/                   EXIT ;
"""


# a step with a compare of its own (cmp_add_u32: y + (y < x)), which is the
# step's and not the loop's
_SASS_CMP_ADD_ILP1 = """
		Function : _Z16alu_probe_kernelILi3ELi1EEvPKjPjxi
        /*0080*/                   ISETP.GE.U32.AND P1, PT, R2, R0, PT ;
        /*0090*/                   VIADD R6, R6, 0x2 ;
        /*00a0*/              @!P1 VIADD R2, R2, 0x1 ;
        /*00b0*/                   ISETP.GE.U32.AND P2, PT, R2, R0, PT ;
        /*00c0*/                   ISETP.NE.AND P0, PT, R6, R7, PT ;
        /*00d0*/              @!P2 VIADD R2, R2, 0x1 ;
        /*00e0*/               @P0 BRA 0x80 ;
        /*00f0*/                   EXIT ;
"""


@pytest.mark.parametrize("case", ["one_wide_ilp1", "one_wide_ilp4", "split_ilp1",
                                  "cmp_add_ilp1"])
def test_step_counts_from_a_sass_listing(case):
    """The chain loop is found from its backward branch (not the trap loop
    after EXIT), its control (the branch, the compare that writes the
    branch's predicate, the counter that compare reads) is left out and a
    compare of the step is kept, and a wide multiply-add is told apart by
    its operands: RZ as its addend (2.5 instructions a step against one),
    both factors in even registers."""
    from stark_verifier_tpu_torch.utils import sass

    text, op, unroll, ilp, want = {
        "one_wide_ilp1": (_SASS_ONE_WIDE_ILP1, "mad_wide_u32", 2, 1,
                          {"IMAD.WIDE.U32 (both factors even)": 1.0}),
        "one_wide_ilp4": (_SASS_ONE_WIDE_ILP4, "mad_wide_u32", 1, 4, {"IMAD.WIDE.U32": 1.0}),
        "split_ilp1": (_SASS_SPLIT_ILP1, "mad_wide_u32", 4, 1,
                       {"IMAD.WIDE.U32 (zero addend)": 1.0, "IADD3": 1.0, "IADD3.X": 0.5}),
        "cmp_add_ilp1": (_SASS_CMP_ADD_ILP1, "cmp_add_u32", 2, 1,
                         {"ISETP.GE.U32.AND": 1.0, "VIADD": 1.0}),
    }[case]
    listing = sass.parse(text)
    (kernel,) = listing
    assert probes.alu_kernel_key(kernel) == (op, ilp)
    (body,) = sass.loop_bodies(listing[kernel])
    assert body[-1] == "BRA" and len(body) == unroll * ilp * sum(want.values()) + 3
    counts = probes.step_sass(listing, unroll)[(op, ilp)]
    assert counts["by_opcode"] == want
    assert counts["instructions_a_step"] == sum(want.values())
    assert counts["loop_control"] == 3
    # the kept design at ilp 1; at ilp 4 it also moves two registers a pass
    designed = counts["by_opcode"] == probes.STEP_SASS.get(op, {}).get(ilp)
    assert designed == (case == "one_wide_ilp1")


@pytest.mark.parametrize("case,want", [("one_wide_ilp1", 2), ("one_wide_ilp4", 2),
                                       ("split_ilp1", 9), ("cmp_add_ilp1", 4)])
def test_critical_path_from_a_sass_listing(case, want):
    """The dependent instructions on the longest register path of a
    listing: two wide multiply-adds on one 64-bit y (the addend read as a
    pair); four independent chains side by side, one step deep, then the
    loop's compare after its counter; the split step's product, low add,
    carry into the high add, twice; a compare whose predicate guards the
    add it feeds, twice. The closing branch and the store are off the
    path."""
    from stark_verifier_tpu_torch.utils import sass

    text = {"one_wide_ilp1": _SASS_ONE_WIDE_ILP1, "one_wide_ilp4": _SASS_ONE_WIDE_ILP4,
            "split_ilp1": _SASS_SPLIT_ILP1, "cmp_add_ilp1": _SASS_CMP_ADD_ILP1}[case]
    (instructions,) = sass.parse(text).values()
    assert sass.critical_path(instructions) == want


def test_one_table_of_least_slots_a_step():
    """Every op has its least count in probes.MIN_PIPE_SLOTS, the bound of
    chip_smoke.py reads it there (one IMAD.WIDE.U32 a mad_wide_u32 step),
    the rate tool keeps no copy of its own, and the chain loop's unroll is
    the one the SASS count divides by."""
    import importlib.util
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    assert set(probes.MIN_PIPE_SLOTS) == set(probes.OPS)
    assert set(probes.STEP_SASS) <= set(probes.OPS)
    assert all(set(by_ilp) == {1, 4} for by_ilp in probes.STEP_SASS.values())
    assert probes.MIN_PIPE_SLOTS["mad_wide_u32"] == 1
    spec = importlib.util.spec_from_file_location("chip_smoke", repo / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.MAD_WIDE_STEP_INSTRUCTIONS == probes.MIN_PIPE_SLOTS["mad_wide_u32"]
    tool = (repo / "tools" / "torch_vpu_microbench.py").read_text()
    assert "MIN_PIPE_SLOTS = {" not in tool and "probes.MIN_PIPE_SLOTS" in tool
    src = (repo / "stark_verifier_tpu_torch" / "ops" / "csrc" / "probes.cu").read_text()
    assert f"#pragma unroll {probes.CHAIN_UNROLL}\n    for (int s = 0; s < chain;" in src
