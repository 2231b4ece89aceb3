// Witness generation and the constraint evaluation of the provers for NVIDIA
// Hopper (sm_90a): the kernels that take the place of the host C planes the
// JAX package calls for its provers (native/svt_poseidon.c, and the numpy
// field's inverse that runs on its svt_gl_mul plane).
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
//   ext2_arith: c0 x y + c1 z in GF(p^2) for two constants, int64[2, L]
//     operands -> int64[2, L], canonical: the ArithmeticExtension and
//     MulExtension (c1 = 0) generators' body. Counterpart of
//     svt_ext2_arith_batch (native/svt_poseidon.c:457).
//   gl_inv, ext2_inv: the field inverse, a^(p - 2) by an addition chain (64
//     squarings, 10 multiplies), int64[L] -> int64[L]; in GF(p^2) the
//     conjugate over the norm a0^2 - 7 a1^2, int64[2, L] -> int64[2, L];
//     canonical, and 0 for 0 (or p). Counterpart of gl64_np.inv
//     (stark_verifier_tpu/ops/gl64_np.py:189), the Fermat power the JAX
//     package's numpy provers run on svt_gl_mul, and of its ext2.inv.
//   poseidon_gate_eval: the 123 PoseidonGate constraints at L points from
//     the gate's 135 wire planes (plane k at wires + k * stride, its L
//     words consecutive) -> int64[123, L], canonical, in the order of
//     core/gates._poseidon_eval_base: the swap's and the deltas' five,
//     full rounds 1..3's s-box inputs, the 22 partial ones, the second
//     half's 48, the 12 outputs. Counterpart of svt_poseidon_eval_batch_p
//     (native/svt_poseidon.c:680), the prover's quotient on the LDE coset.
//
// The three later kernels are one thread a lane, each lane's work in
// registers from its loads to its stores: a first design that is right.
// ext2_arith and the inverses run at 1 to 64 lanes on the recursive
// provers' witness and at a batch's lanes on the verifier, where a launch
// binds; poseidon_gate_eval runs at 2^18 to 2^20 lanes, where the card's
// rates bind: some 33,000 32-bit integer instructions a lane against the
// 258 words it reads and writes, so operations before bytes. The eval reads the
// fill's tables (round constants, forwarded constants, the sparse
// matrices) from FILL_TABLES, which the wrapper uploads once a device.
//
// What bounds the fill and the chain on this card. The recursive provers
// launch each once a gate row at 1, 2, 16 or 64 lanes (a signal's wrap and
// the top level, a level of two pairs, a wrap of 16, a batch of signals), so
// a launch is one lane's latency, never the card's rates: the bounds by bytes and by
// operations are below 0.002 ms, the launch itself some microseconds. One
// thread a lane made each launch one thread's serial chain: the fill's
// ~1,100 dependent multiplies and its table reads from global memory (0.067
// ms), the chain's k steps each behind a load (0.36 us a step). The designs
// shorten that chain:
//
//   * the fill, twelve threads a lane (one state word each) in groups of
//     16, two lanes a warp, one warp a block: the layout of
//     poseidon_permute's narrow grid (poseidon_gl.cu), whose MDS code it
//     shares (poseidon_split.cuh). A full round is one s-box deep a thread
//     and one row; the initial matrix is 11 independent products a thread;
//     a partial round runs the s-box of word 0 on every thread of the group
//     (no divergence, no broadcast) while the threads of words 1..11 form
//     their w-hat products and add them over the group by a butterfly of
//     warp shuffles, so its critical path is the s-box and one product,
//     not 23 products in series. The tables are copied into shared memory
//     once a block, before any round; every wire is stored by the thread
//     that owns its word as soon as it exists. Threads 12..15 of a group,
//     and the group past a ragged end, run along and store nothing, so that
//     every shuffle and every __syncwarp has its whole warp;
//   * the chain, one warp a lane: thread t takes steps base + t and
//     base + 32 + t of each pair of chunks of 32 steps, its coefficients
//     loaded before any arithmetic (the next pair's while a pair ends).
//     Each pair is a Hillis-Steele scan of the affine maps x -> alpha x + c_i
//     (5 levels, B_i += alpha^(2^l) B_(i - 2^l)), the first pair's beside
//     the scan of the multipliers, which ends at alpha^(i + 1); then
//     acc_i = alpha^(i + 1) carry + B_i, and thread 31's accumulator is the
//     next chunk's carry. Field arithmetic is exact and every output
//     canonical, so the reassociation changes no word. The products by 7
//     (and the fill's by 25) are one fold (mul_small), and no product sits
//     under a branch: a branch on the thread's index kept the compiler from
//     interleaving the products of a level.
//
// tools/torch_witness_alternatives.py times both against one thread a lane
// (the design before), the chain as a serial loop over coefficients in
// registers, one chunk a pass, full multiplies for the constants, and the
// fill with its partial rounds unrolled.
//
// Plain C interface (loaded with ctypes): no PyTorch headers, launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
#include "poseidon_split.cuh"

#define FILL_THREADS 32            // one warp a block: SPLIT_PERMS lanes
#define CHAIN_THREADS 32           // one warp a block: one lane
#define FILL_WIRES 135
#define START_OUTPUT 12
#define WIRE_SWAP 24
#define START_DELTA 25
#define START_FULL_0 29
#define START_PARTIAL 65
#define START_FULL_1 87
static_assert(START_FULL_1 + HALF_FULL * WIDTH == FILL_WIRES, "PoseidonGate's 135 wires");
static_assert(SPLIT == WIDTH, "the fill gives each thread of a group one word");

// The fill's tables, one after the other (ops/witness_kernel.fill_tables):
// the 30 x 12 round constants and plonky2's forwarded partial-round
// constants (12 before the first partial round, one a partial round), as
// poseidon_kernel.schedule_tables() gives them; then the fast form's
// 11 x 11 initial matrix and, for each of the 22 partial rounds, its 11
// w-hat and 11 v entries. Every entry is canonical.
#define FIRST_AT (N_ROUNDS * WIDTH)
#define PRC_AT (FIRST_AT + WIDTH)
#define INIT_AT (PRC_AT + N_PARTIAL)
#define WHAT_AT (INIT_AT + (WIDTH - 1) * (WIDTH - 1))
#define VS_AT (WHAT_AT + N_PARTIAL * (WIDTH - 1))
#define FILL_TABLE_WORDS (VS_AT + N_PARTIAL * (WIDTH - 1))
__device__ u64 FILL_TABLES[FILL_TABLE_WORDS];

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr u32 MDS0TO0 = 17 + DIAG0;     // CIRC[0] + DIAG[0]

// a - b mod p for canonical a and b: canonical
__device__ __forceinline__ u64 sub_canonical(u64 a, u64 b) {
    return (a >= b) ? a - b : a + (GL_P - b);
}

// x * c mod p for any representative x and a constant c < 2^32 (7 and 25
// here): the product's high word h is below c, so it folds as lo + h * EPS
// with one carry corrected, as fold_row does, without mul_gl's 64 x 64
// high product and its fold
__device__ __forceinline__ u64 mul_small(u64 x, u32 c) {
    const u64 lo = x * c;
    const u64 t = __umul64hi(x, c) * EPS;    // below 2^64: h < c < 2^32
    const u64 r = lo + t;
    return r + ((r < t) ? EPS : 0ull);       // a wrap leaves r below t
}

// ------------------------------------------------------ poseidon_gate_fill
// One full round on the group: thread q adds its word's constant, records
// the s-box input at wire rec + q (rec < 0: not recorded) where it stores,
// takes the s-box, and computes MDS row q from the group's twelve words,
// which the owners pass through the stage.
__device__ __forceinline__ u64 fill_full_round(u64 mine, const u64* tables, int r, int rec,
                                               u64 (&stage)[WIDTH], bool owner, bool store, int q,
                                               const u32 (&m)[WIDTH], u32 d0,
                                               u64* __restrict__ out, long long L,
                                               long long lane) {
    mine = add_const(mine, tables[r * WIDTH + q]);
    if (rec >= 0 && store) out[(rec + q) * L + lane] = canonical(mine);
    mine = sbox7(mine);
    u32 lo[WIDTH], hi[WIDTH];
    u64 w0;
    split_exchange(stage, owner, q, mine, lo, hi, w0);
    return split_row(m, d0, lo, hi);
}

__global__ void __launch_bounds__(FILL_THREADS)
poseidon_gate_fill_kernel(const u64* __restrict__ in, const u64* __restrict__ swap,
                          u64* __restrict__ out, long long L) {
    __shared__ u64 tables[FILL_TABLE_WORDS];
    __shared__ __align__(16) u64 stage[2][SPLIT_PERMS][WIDTH];
    for (int i = threadIdx.x; i < FILL_TABLE_WORDS; i += FILL_THREADS) tables[i] = FILL_TABLES[i];
    __syncthreads();

    const int g = threadIdx.x / SPLIT_GROUP;
    const bool owner = threadIdx.x % SPLIT_GROUP < SPLIT;
    const int q = owner ? threadIdx.x % SPLIT_GROUP : 0;
    const long long lane = (long long)blockIdx.x * SPLIT_PERMS + g;
    const bool live = lane < L;
    const long long at = live ? lane : 0;
    // the thread that stores word q's wires: an owner of a live lane
    const bool store = owner && live;

    u32 m[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) m[j] = CIRC_TABLE[(j - q + WIDTH) % WIDTH];
    const u32 d0 = (q == 0) ? DIAG0 : 0;

    // inputs, swap, deltas: delta_j = swap * (in[4 + j] - in[j]) for j < 4,
    // computed by both threads of the pair (q, q + 4); the first two words
    // of four change places when swap is 1
    const int lo_word = q & 3;
    const u64 x_lo = canonical(in[lo_word * L + at]);
    const u64 x_hi = canonical(in[(lo_word + 4) * L + at]);
    const u64 x = canonical(in[q * L + at]);
    const u64 sw = canonical(swap[at]);
    if (store) out[q * L + lane] = x;
    if (store && q == 0) out[WIRE_SWAP * L + lane] = sw;
    u64 mine = x;
    if (q < 8) {
        const u64 d = canonical(mul_gl(sw, sub_canonical(x_hi, x_lo)));
        if (store && q < 4) out[(START_DELTA + q) * L + lane] = d;
        mine = (q < 4) ? add_gl(x_lo, d) : sub_canonical(x_hi, d);
    }

    // the first half's full rounds: round 0 not recorded, 1..3 recorded
    int b = 0;
#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r, b ^= 1)
        mine = fill_full_round(mine, tables, r, r == 0 ? -1 : START_FULL_0 + WIDTH * (r - 1),
                               stage[b][g], owner, store, q, m, d0, out, L, lane);

    // the forwarded constants, then the initial matrix on words 1..11:
    // thread c + 1 takes t[c] = sum_r M[r][c] * s[1 + r], 11 independent
    // products summed in two chains; every thread keeps word 0 as w0
    mine = add_const(mine, tables[FIRST_AT + q]);
    u64 w0;
    {
        u32 lo[WIDTH], hi[WIDTH];
        split_exchange(stage[b][g], owner, q, mine, lo, hi, w0);
        b ^= 1;
        const int c = (q > 0) ? q - 1 : 0;
        u64 t[2] = {0, 0};
#pragma unroll
        for (int r = 0; r < WIDTH - 1; ++r) {
            const u64 word = ((u64)hi[1 + r] << 32) | lo[1 + r];
            t[r % 2] = add_gl(t[r % 2], mul_gl(tables[INIT_AT + r * (WIDTH - 1) + c], word));
        }
        mine = add_gl(t[0], t[1]);
    }

    // the 22 sparse rounds: thread q > 0 holds word q, every thread word 0.
    // sum = sum_j w-hat[r][j] s[1 + j] needs no s-box: its products and the
    // butterfly over the group run beside the s-box of word 0. The
    // butterfly's adds commute, so every thread of the group ends with the
    // same representative, and w0 stays equal across the group.
    const int j = (q > 0) ? q - 1 : 0;
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL; ++r) {
        if (store && q == 0) out[(START_PARTIAL + r) * L + lane] = canonical(w0);
        u64 sum = mul_gl(tables[WHAT_AT + r * (WIDTH - 1) + j], mine);
        if (q == 0) sum = 0;           // a select, not a branch around the product
#pragma unroll
        for (int k = SPLIT_GROUP / 2; k > 0; k /= 2)
            sum = add_gl(sum, __shfl_xor_sync(FULL_MASK, sum, k));
        // the last round's constant is 0: adding it is plonky2's skip
        const u64 s0 = add_const(sbox7(w0), tables[PRC_AT + r]);
        mine = add_gl(mul_gl(tables[VS_AT + r * (WIDTH - 1) + j], s0), mine);
        w0 = add_gl(mul_small(s0, MDS0TO0), sum);
    }
    if (q == 0) mine = w0;

    // the second half's full rounds, all recorded
#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r, b ^= 1)
        mine = fill_full_round(mine, tables, HALF_FULL + N_PARTIAL + r, START_FULL_1 + WIDTH * r,
                               stage[b][g], owner, store, q, m, d0, out, L, lane);
    if (store) out[(START_OUTPUT + q) * L + lane] = canonical(mine);
}

// ------------------------------------------------------- ext2_reduce_chain
struct ext2 {
    u64 a, b;   // a + b X
};

__device__ __forceinline__ ext2 ext2_mul(ext2 x, ext2 y) {
    return {add_gl(mul_gl(x.a, y.a), mul_small(mul_gl(x.b, y.b), 7)),
            add_gl(mul_gl(x.a, y.b), mul_gl(x.b, y.a))};
}

__device__ __forceinline__ ext2 ext2_add(ext2 x, ext2 y) {
    return {add_gl(x.a, y.a), add_gl(x.b, y.b)};
}

__device__ __forceinline__ ext2 ext2_shfl_up(ext2 x, int d) {
    return {__shfl_up_sync(FULL_MASK, x.a, d), __shfl_up_sync(FULL_MASK, x.b, d)};
}

// coefficient i of the lane, 0 past the end
__device__ __forceinline__ ext2 chain_coeff(const u64* __restrict__ coeffs, int i, int k,
                                            long long L, long long lane) {
    if (i >= k) return {0, 0};
    return {coeffs[(2ll * i) * L + lane], coeffs[(2ll * i + 1) * L + lane]};
}

// One level of the scan over two chunks: B_t += m B_(t - d) in each, m the
// multiplier of the d steps before (alpha^d). Below d there is no step at
// that distance and B_t += m * 0 leaves B_t's word as it is; the products
// run on every thread, so that the level is one block of code the
// compiler interleaves (under a branch on t, each product waited on the
// one before it).
__device__ __forceinline__ void chain_level(ext2& B0, ext2& B1, ext2 m, int t, int d) {
    ext2 up0 = ext2_shfl_up(B0, d), up1 = ext2_shfl_up(B1, d);
    if (t < d) up0 = up1 = {0, 0};
    B0 = ext2_add(B0, ext2_mul(m, up0));
    B1 = ext2_add(B1, ext2_mul(m, up1));
}

// The chunk's accumulators from the carry: x_t = alpha^(t + 1) carry + B_t,
// stored where step base + t exists; returns thread 31's, the next carry.
__device__ __forceinline__ ext2 chain_finish(ext2 B, ext2 at, ext2 carry, int base, int t,
                                             int k, u64* __restrict__ out, long long L,
                                             long long lane) {
    const ext2 x = ext2_add(ext2_mul(at, carry), B);
    const int i = base + t;
    if (i < k) {
        out[(2ll * i) * L + lane] = canonical(x.a);
        out[(2ll * i + 1) * L + lane] = canonical(x.b);
    }
    return {__shfl_sync(FULL_MASK, x.a, 31), __shfl_sync(FULL_MASK, x.b, 31)};
}

// Thread t takes steps base + t and base + 32 + t of each pair of chunks.
// The first pair's scan also scans the maps' multipliers, A_t <- A_t
// A_(t - d) (A_t * 1 below d): before level l, A_t = alpha^(2^l) for
// t >= 2^l (kept in m[l] for the later pairs), and after the last,
// A_t = alpha^(t + 1). The two chunks' scans and the multipliers' are
// independent: each level is one product deep.
__global__ void __launch_bounds__(CHAIN_THREADS)
ext2_reduce_chain_kernel(const u64* __restrict__ alpha, const u64* __restrict__ acc,
                         const u64* __restrict__ coeffs, u64* __restrict__ out,
                         int k, long long L) {
    const long long lane = blockIdx.x;
    const int t = threadIdx.x;
    ext2 B0 = chain_coeff(coeffs, t, k, L, lane);
    ext2 B1 = chain_coeff(coeffs, 32 + t, k, L, lane);
    ext2 A = {alpha[lane], alpha[L + lane]};
    ext2 carry = {acc[lane], acc[L + lane]};
    ext2 m[5];
#pragma unroll
    for (int l = 0; l < 5; ++l) {
        const int d = 1 << l;
        ext2 up = ext2_shfl_up(A, d);
        if (t < d) up = {1, 0};
        m[l] = A;
        chain_level(B0, B1, A, t, d);
        A = ext2_mul(A, up);
    }
#pragma unroll 1
    for (int base = 0;; base += 64) {
        // the next pair's coefficients are in flight while this one ends
        const ext2 next0 = chain_coeff(coeffs, base + 64 + t, k, L, lane);
        const ext2 next1 = chain_coeff(coeffs, base + 96 + t, k, L, lane);
        carry = chain_finish(B0, A, carry, base, t, k, out, L, lane);
        if (base + 32 >= k) break;
        carry = chain_finish(B1, A, carry, base + 32, t, k, out, L, lane);
        if (base + 64 >= k) break;
        B0 = next0;
        B1 = next1;
#pragma unroll
        for (int l = 0; l < 5; ++l) chain_level(B0, B1, m[l], t, 1 << l);
    }
}

// ------------------------------------------------------ one thread a lane
#define LANE_THREADS 128           // ext2_arith, the inverses, the eval
#define EVAL_CONSTRAINTS 123
static_assert(1 + 4 + 3 * WIDTH + N_PARTIAL + HALF_FULL * WIDTH + WIDTH == EVAL_CONSTRAINTS,
              "PoseidonGate's 123 constraints");

// a - b mod p for any representatives: canonical
__device__ __forceinline__ u64 sub_any(u64 a, u64 b) {
    return sub_canonical(canonical(a), canonical(b));
}

// -a mod p for a canonical a: canonical
__device__ __forceinline__ u64 neg_canonical(u64 a) {
    return a ? GL_P - a : 0ull;
}

__device__ __forceinline__ long long lane_index() {
    return (long long)blockIdx.x * LANE_THREADS + threadIdx.x;
}

// ext2_arith: out = c0 (x y) + c1 z, x y by the schoolbook product of
// ext2_mul (X^2 = 7)
__global__ void __launch_bounds__(LANE_THREADS)
ext2_arith_kernel(u64 c0, u64 c1, const u64* __restrict__ x, const u64* __restrict__ y,
                  const u64* __restrict__ z, u64* __restrict__ out, long long L) {
    const long long i = lane_index();
    if (i >= L) return;
    const ext2 p = ext2_mul({x[i], x[L + i]}, {y[i], y[L + i]});
    out[i] = canonical(add_gl(mul_gl(c0, p.a), mul_gl(c1, z[i])));
    out[L + i] = canonical(add_gl(mul_gl(c0, p.b), mul_gl(c1, z[L + i])));
}

// x^(2^k): k squarings
template <int K>
__device__ __forceinline__ u64 square_n(u64 x) {
#pragma unroll
    for (int j = 0; j < K; ++j) x = mul_gl(x, x);
    return x;
}

// a^(p - 2), canonical. With t_k = a^(2^k - 1), t_(j + k) = t_j^(2^k) t_k,
// and p - 2 = (2^31 - 1) 2^33 + (2^32 - 1): t_1, t_2, t_4, t_8, t_16, then
// t_24, t_28, t_30, t_31, t_32, and t_31^(2^33) t_32. 64 squarings and 10
// multiplies where square-and-multiply takes 63 and 62. a = 0 gives 0.
__device__ __forceinline__ u64 inv_gl(u64 a) {
    const u64 t1 = a;
    const u64 t2 = mul_gl(square_n<1>(t1), t1);
    const u64 t4 = mul_gl(square_n<2>(t2), t2);
    const u64 t8 = mul_gl(square_n<4>(t4), t4);
    const u64 t16 = mul_gl(square_n<8>(t8), t8);
    const u64 t24 = mul_gl(square_n<8>(t16), t8);
    const u64 t28 = mul_gl(square_n<4>(t24), t4);
    const u64 t30 = mul_gl(square_n<2>(t28), t2);
    const u64 t31 = mul_gl(square_n<1>(t30), t1);
    const u64 t32 = mul_gl(square_n<1>(t31), t1);
    return canonical(mul_gl(square_n<33>(t31), t32));
}

__global__ void __launch_bounds__(LANE_THREADS)
gl_inv_kernel(const u64* __restrict__ a, u64* __restrict__ out, long long L) {
    const long long i = lane_index();
    if (i >= L) return;
    out[i] = inv_gl(a[i]);
}

// (a0 + a1 X)^-1 = (a0 - a1 X) / (a0^2 - 7 a1^2); the norm is 0 only for 0
__global__ void __launch_bounds__(LANE_THREADS)
ext2_inv_kernel(const u64* __restrict__ a, u64* __restrict__ out, long long L) {
    const long long i = lane_index();
    if (i >= L) return;
    const u64 a0 = a[i], a1 = a[L + i];
    const u64 n = inv_gl(sub_any(mul_gl(a0, a0), mul_small(mul_gl(a1, a1), 7)));
    out[i] = canonical(mul_gl(a0, n));
    out[L + i] = neg_canonical(canonical(mul_gl(a1, n)));
}

// ------------------------------------------------------ poseidon_gate_eval
// The dense MDS layer on one thread's twelve words: row q's coefficient of
// word j is CIRC[(j - q) mod 12], with 8 more on word 0 of row 0, summed on
// the words' 32-bit halves in split_row's two chains and folded.
__device__ __forceinline__ void mds_thread(u64 (&s)[WIDTH]) {
    const u32 circ[WIDTH] = MDS_CIRC;
    u32 lo[WIDTH], hi[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        lo[j] = (u32)s[j];
        hi[j] = (u32)(s[j] >> 32);
    }
#pragma unroll
    for (int q = 0; q < WIDTH; ++q) {
        u32 m[WIDTH];
#pragma unroll
        for (int j = 0; j < WIDTH; ++j) m[j] = circ[(j - q + WIDTH) % WIDTH];
        s[q] = split_row(m, q == 0 ? DIAG0 : 0u, lo, hi);
    }
}

// The constraints of one lane, each stored as soon as it exists: a
// constraint is the state word the permutation reaches minus the wire that
// records it, and the recorded wire, not the state word, goes on.
__global__ void __launch_bounds__(LANE_THREADS)
poseidon_gate_eval_kernel(const u64* __restrict__ w, long long stride,
                          u64* __restrict__ out, long long L) {
    const long long i = lane_index();
    if (i >= L) return;
    const u64* __restrict__ t = FILL_TABLES;
    const u64* __restrict__ lane = w + i;
    u64* __restrict__ o = out + i;
#define WIRE(k) lane[(long long)(k) * stride]
#define EMIT(c, v) o[(long long)(c) * L] = (v)

    // the swap bit and the deltas; the swapped inputs
    const u64 swap = WIRE(WIRE_SWAP);
    EMIT(0, sub_any(mul_gl(swap, swap), swap));
    u64 s[WIDTH];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const u64 x_lo = WIRE(k), x_hi = WIRE(k + 4), d = WIRE(START_DELTA + k);
        EMIT(1 + k, sub_any(mul_gl(swap, sub_any(x_hi, x_lo)), d));
        s[k] = add_gl(x_lo, d);
        s[k + 4] = sub_any(x_hi, d);
    }
#pragma unroll
    for (int k = 8; k < WIDTH; ++k) s[k] = WIRE(k);

    // the first half: round 0 from the state, rounds 1..3 from their wires
#pragma unroll
    for (int q = 0; q < WIDTH; ++q) s[q] = sbox7(add_const(s[q], t[q]));
    mds_thread(s);
    int c = 5;
#pragma unroll 1
    for (int r = 1; r < HALF_FULL; ++r) {
#pragma unroll
        for (int q = 0; q < WIDTH; ++q) {
            const u64 sb = WIRE(START_FULL_0 + WIDTH * (r - 1) + q);
            EMIT(c + q, sub_any(add_const(s[q], t[r * WIDTH + q]), sb));
            s[q] = sbox7(sb);
        }
        c += WIDTH;
        mds_thread(s);
    }

    // the forwarded constants, the initial matrix on words 1..11 (word c + 1
    // takes sum_r M[r][c] s[1 + r]), then the 22 sparse rounds
#pragma unroll
    for (int q = 0; q < WIDTH; ++q) s[q] = add_const(s[q], t[FIRST_AT + q]);
    {
        u64 u[WIDTH - 1];
#pragma unroll
        for (int k = 0; k < WIDTH - 1; ++k) {
            u64 sum = 0;
#pragma unroll
            for (int r = 0; r < WIDTH - 1; ++r)
                sum = add_gl(sum, mul_gl(t[INIT_AT + r * (WIDTH - 1) + k], s[1 + r]));
            u[k] = sum;
        }
#pragma unroll
        for (int k = 0; k < WIDTH - 1; ++k) s[1 + k] = u[k];
    }
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL; ++r) {
        const u64 sb = WIRE(START_PARTIAL + r);
        EMIT(c + r, sub_any(s[0], sb));
        // the last round's constant is 0: adding it is plonky2's skip
        const u64 s0 = add_const(sbox7(sb), t[PRC_AT + r]);
        u64 d = mul_small(s0, MDS0TO0);
#pragma unroll
        for (int j = 0; j < WIDTH - 1; ++j) {
            d = add_gl(d, mul_gl(t[WHAT_AT + r * (WIDTH - 1) + j], s[1 + j]));
            s[1 + j] = add_gl(mul_gl(t[VS_AT + r * (WIDTH - 1) + j], s0), s[1 + j]);
        }
        s[0] = d;
    }
    c += N_PARTIAL;

    // the second half, every round from its wires; then the outputs
#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r) {
#pragma unroll
        for (int q = 0; q < WIDTH; ++q) {
            const u64 sb = WIRE(START_FULL_1 + WIDTH * r + q);
            EMIT(c + q, sub_any(add_const(s[q], t[(HALF_FULL + N_PARTIAL + r) * WIDTH + q]), sb));
            s[q] = sbox7(sb);
        }
        c += WIDTH;
        mds_thread(s);
    }
#pragma unroll
    for (int q = 0; q < WIDTH; ++q) EMIT(c + q, sub_any(s[q], WIRE(START_OUTPUT + q)));
#undef WIRE
#undef EMIT
}

// an empty kernel: the least time a launch of this library takes
__global__ void witness_empty_kernel() {}

extern "C" {

// Copies the fill's FILL_TABLE_WORDS table words (host memory) into
// FILL_TABLES on the current device.
int witness_set_tables(const void* host_u64) {
    return (int)cudaMemcpyToSymbol(FILL_TABLES, host_u64, sizeof(u64) * FILL_TABLE_WORDS);
}

int witness_table_words() { return FILL_TABLE_WORDS; }

// in: u64[12, L], swap: u64[L], out: u64[135, L], device pointers, out
// distinct from both.
int poseidon_gate_fill(const void* in, const void* swap, void* out, long long L,
                       void* stream) {
    if (L <= 0) return 0;
    long long blocks = (L + SPLIT_PERMS - 1) / SPLIT_PERMS;
    poseidon_gate_fill_kernel<<<(unsigned)blocks, FILL_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)in, (const u64*)swap, (u64*)out, L);
    return (int)cudaGetLastError();
}

// alpha, acc: u64[2, L], coeffs: u64[k, 2, L], out: u64[k, 2, L], device
// pointers, out distinct from the others.
int ext2_reduce_chain(const void* alpha, const void* acc, const void* coeffs, void* out,
                      int k, long long L, void* stream) {
    if (L <= 0 || k <= 0) return 0;
    ext2_reduce_chain_kernel<<<(unsigned)L, CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)alpha, (const u64*)acc, (const u64*)coeffs, (u64*)out, k, L);
    return (int)cudaGetLastError();
}

static unsigned lane_blocks(long long L) {
    return (unsigned)((L + LANE_THREADS - 1) / LANE_THREADS);
}

// x, y, z, out: u64[2, L], device pointers, out distinct from the others;
// c0 and c1 canonical.
int ext2_arith(unsigned long long c0, unsigned long long c1, const void* x, const void* y,
               const void* z, void* out, long long L, void* stream) {
    if (L <= 0) return 0;
    ext2_arith_kernel<<<lane_blocks(L), LANE_THREADS, 0, (cudaStream_t)stream>>>(
        c0, c1, (const u64*)x, (const u64*)y, (const u64*)z, (u64*)out, L);
    return (int)cudaGetLastError();
}

// a, out: u64[L], device pointers, distinct.
int gl_inv(const void* a, void* out, long long L, void* stream) {
    if (L <= 0) return 0;
    gl_inv_kernel<<<lane_blocks(L), LANE_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)a, (u64*)out, L);
    return (int)cudaGetLastError();
}

// a, out: u64[2, L], device pointers, distinct.
int ext2_inv(const void* a, void* out, long long L, void* stream) {
    if (L <= 0) return 0;
    ext2_inv_kernel<<<lane_blocks(L), LANE_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)a, (u64*)out, L);
    return (int)cudaGetLastError();
}

// wires: 135 planes of L words, plane k at wires + k * stride (words);
// out: u64[123, L]; device pointers, out distinct from the planes.
int poseidon_gate_eval(const void* wires, long long stride, void* out, long long L,
                       void* stream) {
    if (L <= 0) return 0;
    poseidon_gate_eval_kernel<<<lane_blocks(L), LANE_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)wires, stride, (u64*)out, L);
    return (int)cudaGetLastError();
}

// one launch of the empty kernel, one block of 32 threads
int witness_empty(void* stream) {
    witness_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

}  // extern "C"
