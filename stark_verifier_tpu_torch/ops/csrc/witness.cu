// Witness generation of the recursive circuits for NVIDIA Hopper (sm_90a):
// the two kernels that take the place of the host C planes the JAX package
// calls for its recursion prover (native/svt_poseidon.c).
//
//   poseidon_gate_fill: all 135 wires of a PoseidonGate row for L lanes,
//     int64[12, L] inputs and int64[L] swap bits -> int64[135, L], canonical,
//     in the gate's wire order (core/gates.py PoseidonGate): inputs,
//     outputs, swap, the four deltas, full rounds 1..3 of the first half,
//     the 22 partial s-box inputs, the second half's four full rounds. The
//     permutation runs in plonky2's fast-partial-round form (the forwarded
//     constants, the initial matrix, 22 sparse rounds), whose s-box inputs
//     are the wires the gate records. Counterpart of
//     svt_poseidon_fill_batch (native/svt_poseidon.c:434).
//   ext2_reduce_chain: every intermediate accumulator of a Horner chain in
//     GF(p^2) = GF(p)[X]/(X^2 - 7): acc <- acc * alpha + c_i for k
//     coefficients, int64[2, L] alpha and old accumulator, int64[k, 2, L]
//     coefficients (base or extension) -> int64[k, 2, L], canonical.
//     Counterpart of svt_ext2_reduce_chain (native/svt_poseidon.c:474).
//
// Both run one thread a lane. The recursive provers call them at 1 to 64
// lanes (a wrap, a level of pairs, a batch of signals), once a gate row, so
// a launch is all their time; the design is the simplest that is right:
// every step a full Goldilocks multiply (goldilocks.cuh), the full rounds'
// MDS as poseidon_gl.cu computes it (32-bit halves, one fold a row), the
// tables read from global memory, each value written as soon as it exists.
//
// Plain C interface (loaded with ctypes): no PyTorch headers, launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
#include "goldilocks.cuh"

#define FILL_THREADS 64
#define CHAIN_THREADS 64
#define FILL_WIRES 135
#define START_OUTPUT 12
#define WIRE_SWAP 24
#define START_DELTA 25
#define START_FULL_0 29
#define START_PARTIAL 65
#define START_FULL_1 87
static_assert(START_FULL_1 + HALF_FULL * WIDTH == FILL_WIRES, "PoseidonGate's 135 wires");

// The fill's tables, one after the other (ops/witness_kernel.fill_tables):
// the 30 x 12 round constants and plonky2's forwarded partial-round
// constants (12 before the first partial round, one a partial round), as
// poseidon_kernel.schedule_tables() gives them; then the fast form's
// 11 x 11 initial matrix and, for each of the 22 partial rounds, its 11
// w-hat and 11 v entries.
#define FIRST_AT (N_ROUNDS * WIDTH)
#define PRC_AT (FIRST_AT + WIDTH)
#define INIT_AT (PRC_AT + N_PARTIAL)
#define WHAT_AT (INIT_AT + (WIDTH - 1) * (WIDTH - 1))
#define VS_AT (WHAT_AT + N_PARTIAL * (WIDTH - 1))
#define FILL_TABLE_WORDS (VS_AT + N_PARTIAL * (WIDTH - 1))
__device__ u64 FILL_TABLES[FILL_TABLE_WORDS];

#define MDS_CIRC {17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20}
constexpr u32 DIAG0 = 8;

// a - b mod p for canonical a and b: canonical
__device__ __forceinline__ u64 sub_canonical(u64 a, u64 b) {
    return (a >= b) ? a - b : a + (GL_P - b);
}

// (sum_lo + sum_hi * 2^32) mod p for an MDS row's two partial sums, each
// below 2^41: poseidon_gl.cu's fold_row.
__device__ __forceinline__ u64 fold_row(u64 sum_lo, u64 sum_hi) {
    u64 lo = sum_lo + (sum_hi << 32);
    u32 h = (u32)(sum_hi >> 32) + ((lo < sum_lo) ? 1u : 0u);
    u64 t = (u64)h * EPS;
    u64 r = lo + t;
    return r + ((r < t) ? EPS : 0ull);
}

// the dense MDS layer: out[r] = sum_t CIRC[t] * s[(r + t) % 12] + 8 * s[0]
// in row 0, on the words' 32-bit halves (poseidon_gl.cu's mds_layer)
__device__ __forceinline__ void mds_layer(u64 (&s)[WIDTH]) {
    constexpr u32 CIRC[WIDTH] = MDS_CIRC;
    u32 lo[WIDTH], hi[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        lo[j] = (u32)s[j];
        hi[j] = (u32)(s[j] >> 32);
    }
#pragma unroll
    for (int r = 0; r < WIDTH; ++r) {
        u64 sum_lo = 0, sum_hi = 0;
#pragma unroll
        for (int t = 0; t < WIDTH; ++t) {
            sum_lo += (u64)lo[(r + t) % WIDTH] * CIRC[t];
            sum_hi += (u64)hi[(r + t) % WIDTH] * CIRC[t];
        }
        if (r == 0) {
            sum_lo += (u64)lo[0] * DIAG0;
            sum_hi += (u64)hi[0] * DIAG0;
        }
        s[r] = fold_row(sum_lo, sum_hi);
    }
}

// a full round whose s-box inputs (the state after the round constants)
// are recorded at wires `rec` (rec < 0: not recorded)
__device__ __forceinline__ void full_round(u64 (&s)[WIDTH], int r, u64* out, int rec,
                                           long long L, long long i) {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        s[j] = add_gl(s[j], FILL_TABLES[r * WIDTH + j]);
        if (rec >= 0) out[(rec + j) * L + i] = canonical(s[j]);
        s[j] = sbox7(s[j]);
    }
    mds_layer(s);
}

__global__ void __launch_bounds__(FILL_THREADS)
poseidon_gate_fill_kernel(const u64* __restrict__ in, const u64* __restrict__ swap,
                          u64* __restrict__ out, long long L) {
    long long i = (long long)blockIdx.x * FILL_THREADS + threadIdx.x;
    if (i >= L) return;
    u64 x[WIDTH], s[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        x[j] = canonical(in[j * L + i]);
        out[j * L + i] = x[j];
    }
    const u64 sw = canonical(swap[i]);
    out[WIRE_SWAP * L + i] = sw;
    // delta_j = swap * (in[4 + j] - in[j]): the first two words of four
    // change places when swap is 1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        u64 d = canonical(mul_gl(sw, sub_canonical(x[4 + j], x[j])));
        out[(START_DELTA + j) * L + i] = d;
        s[j] = add_gl(x[j], d);
        s[4 + j] = sub_canonical(x[4 + j], d);
        s[8 + j] = x[8 + j];
    }

    full_round(s, 0, out, -1, L, i);
#pragma unroll 1
    for (int r = 1; r < HALF_FULL; ++r)
        full_round(s, r, out, START_FULL_0 + WIDTH * (r - 1), L, i);

    // partial rounds, plonky2's fast form: the forwarded constants, the
    // initial matrix on words 1..11 (result[c] = sum_r M[r][c] * s[r]), then
    // a sparse matrix a round
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = add_gl(s[j], FILL_TABLES[FIRST_AT + j]);
    {
        u64 t[WIDTH - 1];
#pragma unroll
        for (int c = 0; c < WIDTH - 1; ++c) t[c] = 0;
#pragma unroll 1
        for (int r = 0; r < WIDTH - 1; ++r) {
            const u64 v = s[1 + r];
#pragma unroll
            for (int c = 0; c < WIDTH - 1; ++c)
                t[c] = add_gl(t[c], mul_gl(FILL_TABLES[INIT_AT + r * (WIDTH - 1) + c], v));
        }
#pragma unroll
        for (int c = 0; c < WIDTH - 1; ++c) s[1 + c] = t[c];
    }
    constexpr u32 MDS0TO0 = 17 + DIAG0;   // CIRC[0] + DIAG[0]
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL; ++r) {
        out[(START_PARTIAL + r) * L + i] = canonical(s[0]);
        // the last round's constant is 0: adding it is plonky2's skip
        const u64 s0 = add_gl(sbox7(s[0]), FILL_TABLES[PRC_AT + r]);
        u64 d = mul_gl(s0, MDS0TO0);
#pragma unroll
        for (int j = 0; j < WIDTH - 1; ++j) {
            d = add_gl(d, mul_gl(FILL_TABLES[WHAT_AT + r * (WIDTH - 1) + j], s[1 + j]));
            s[1 + j] = add_gl(mul_gl(FILL_TABLES[VS_AT + r * (WIDTH - 1) + j], s0), s[1 + j]);
        }
        s[0] = d;
    }

#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r)
        full_round(s, HALF_FULL + N_PARTIAL + r, out, START_FULL_1 + WIDTH * r, L, i);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) out[(START_OUTPUT + j) * L + i] = canonical(s[j]);
}

// acc <- acc * alpha + c_i in GF(p)[X]/(X^2 - 7), every accumulator stored
__global__ void __launch_bounds__(CHAIN_THREADS)
ext2_reduce_chain_kernel(const u64* __restrict__ alpha, const u64* __restrict__ acc,
                         const u64* __restrict__ coeffs, u64* __restrict__ out,
                         int k, long long L) {
    long long i = (long long)blockIdx.x * CHAIN_THREADS + threadIdx.x;
    if (i >= L) return;
    const u64 a0 = alpha[i], a1 = alpha[L + i];
    u64 x0 = acc[i], x1 = acc[L + i];
#pragma unroll 1
    for (int j = 0; j < k; ++j) {
        const u64 t0 = add_gl(mul_gl(x0, a0), mul_gl(mul_gl(x1, a1), 7ull));
        const u64 t1 = add_gl(mul_gl(x0, a1), mul_gl(x1, a0));
        x0 = add_gl(t0, coeffs[(2 * j) * L + i]);
        x1 = add_gl(t1, coeffs[(2 * j + 1) * L + i]);
        out[(2 * j) * L + i] = canonical(x0);
        out[(2 * j + 1) * L + i] = canonical(x1);
    }
}

extern "C" {

// Copies the fill's FILL_TABLE_WORDS table words (host memory) into
// FILL_TABLES.
int witness_set_tables(const void* host_u64) {
    return (int)cudaMemcpyToSymbol(FILL_TABLES, host_u64, sizeof(u64) * FILL_TABLE_WORDS);
}

int witness_table_words() { return FILL_TABLE_WORDS; }

// in: u64[12, L], swap: u64[L], out: u64[135, L], device pointers, out
// distinct from both.
int poseidon_gate_fill(const void* in, const void* swap, void* out, long long L,
                       void* stream) {
    if (L <= 0) return 0;
    long long blocks = (L + FILL_THREADS - 1) / FILL_THREADS;
    poseidon_gate_fill_kernel<<<(unsigned)blocks, FILL_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)in, (const u64*)swap, (u64*)out, L);
    return (int)cudaGetLastError();
}

// alpha, acc: u64[2, L], coeffs: u64[k, 2, L], out: u64[k, 2, L], device
// pointers, out distinct from the others.
int ext2_reduce_chain(const void* alpha, const void* acc, const void* coeffs, void* out,
                      int k, long long L, void* stream) {
    if (L <= 0 || k <= 0) return 0;
    long long blocks = (L + CHAIN_THREADS - 1) / CHAIN_THREADS;
    ext2_reduce_chain_kernel<<<(unsigned)blocks, CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)alpha, (const u64*)acc, (const u64*)coeffs, (u64*)out, k, L);
    return (int)cudaGetLastError();
}

}  // extern "C"
