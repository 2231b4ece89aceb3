// The elementwise Goldilocks field plane for NVIDIA Hopper (sm_90a): one
// launch for each call of ops/gl64.py's mul, add, sub, mul_add and
// mul_small on a CUDA tensor, where each was a chain of 11 to 52
// elementwise PyTorch kernels.
//
//   gl_mul        out = a * b
//   gl_add        out = a + b
//   gl_sub        out = a - b         (a null `a` reads 0: gl64.neg)
//   gl_mul_add    out = a * b + c
//   gl_mul_small  out = a * k         (k < 2^15, by value)
//
// None replaces a TPU kernel: on the TPU, XLA fuses gl64_jax's chain of
// each into one fusion, and the JAX package's host provers call its C plane
// once an array (svt_gl_mul, svt_gl_add_arr, svt_gl_sub_arr,
// svt_gl_mul_add, native/svt_poseidon.c:277-339). These kernels are the
// card's counterpart of both.
//
// Every word is the plain version's own, not only equal mod p: the same
// branch-free formulas on native u64 (reduce128 of the 64x64 product for
// mul, as gl64._reduce128 over gl64._mul128; add_gl, as gl64.add; the
// double-borrow subtraction of gl64.sub), nothing canonicalised. mul_small's
// plain version folds the halves' products a_lo k + a_hi k 2^32; that is
// the same 128-bit product, so the same fold of it gives the same word.
// So the card's and the CPU's paths agree word for word at every
// intermediate value, and a test compares with torch.equal.
//
// Operands: one thread an element over the output's elements, a grid-stride
// loop. The wrapper (ops/field_kernel.py) collapses the broadcast shape and
// each operand's strides (0 on a broadcast dim) to at most FIELD_MAX_RANK
// dims and passes them by value; one dim (same shapes, contiguous: the
// common case) takes the kernel without index arithmetic, more dims the one
// that divides the element's index into the dims. Strided views and
// broadcast operands are read where they lie: no copy, which would be a
// launch of its own. The output is a fresh contiguous tensor.
//
// What bounds them: at the paths' sizes (1 to ~10^5 elements) the launch;
// at the card's width bytes (24 a word for mul, add and sub, 32 for
// mul_add, 16 for mul_small) against ~10 to 30 integer instructions a word.
// So the design is the simplest that reads each word once.
//
// Plain C interface (loaded with ctypes): no PyTorch headers, launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
#include "goldilocks.cuh"

#define FIELD_THREADS 256
#define FIELD_MAX_RANK 6
#define FIELD_MAX_BLOCKS 8192        // grid-stride above that: 62 blocks an SM
#define FIELD_GEOM_WORDS (2 + FIELD_MAX_RANK + 3 * FIELD_MAX_RANK)

enum { OP_MUL = 0, OP_ADD = 1, OP_SUB = 2, OP_MUL_ADD = 3, OP_MUL_SMALL = 4 };

// The output's collapsed shape and the operands' strides in words, outer
// dim first (ops/field_kernel.launch_args builds it).
struct FieldGeom {
    long long n;                                 // elements of the output
    long long rank;                              // 1..FIELD_MAX_RANK
    long long shape[FIELD_MAX_RANK];
    long long stride[3][FIELD_MAX_RANK];         // operands a, b, c
};

template <int OP>
__device__ __forceinline__ u64 field_op(u64 x, u64 y, u64 z, u64 k) {
    if (OP == OP_MUL) return mul_gl(x, y);
    if (OP == OP_ADD) return add_gl(x, y);
    if (OP == OP_SUB) return sub_gl(x, y);
    if (OP == OP_MUL_ADD) return add_gl(mul_gl(x, y), z);
    return mul_gl(x, k);                         // OP_MUL_SMALL
}

// Operands OP reads: a and b, c for mul_add, a alone for mul_small.
template <int OP> __device__ constexpr bool reads_b() { return OP != OP_MUL_SMALL; }
template <int OP> __device__ constexpr bool reads_c() { return OP == OP_MUL_ADD; }

template <int OP, bool RANK1>
__device__ __forceinline__ void field_loop(const u64* __restrict__ a,
                                           const u64* __restrict__ b,
                                           const u64* __restrict__ c,
                                           u64* __restrict__ out, u64 k,
                                           const FieldGeom& g) {
    const long long step = (long long)gridDim.x * FIELD_THREADS;
#pragma unroll 1
    for (long long i = (long long)blockIdx.x * FIELD_THREADS + threadIdx.x; i < g.n;
         i += step) {
        long long oa, ob = 0, oc = 0;
        if (RANK1) {
            oa = i * g.stride[0][0];
            if (reads_b<OP>()) ob = i * g.stride[1][0];
            if (reads_c<OP>()) oc = i * g.stride[2][0];
        } else {
            oa = 0;
            long long rest = i;
#pragma unroll
            for (int d = FIELD_MAX_RANK - 1; d >= 0; --d) {
                if (d >= g.rank) continue;
                const long long q = rest / g.shape[d];
                const long long at = rest - q * g.shape[d];
                rest = q;
                oa += at * g.stride[0][d];
                if (reads_b<OP>()) ob += at * g.stride[1][d];
                if (reads_c<OP>()) oc += at * g.stride[2][d];
            }
        }
        const u64 x = a ? a[oa] : 0ull;          // null a: gl64.neg's zero
        const u64 y = reads_b<OP>() ? b[ob] : 0ull;
        const u64 z = reads_c<OP>() ? c[oc] : 0ull;
        out[i] = field_op<OP>(x, y, z, k);
    }
}

#define FIELD_KERNEL(name, OP)                                                          \
    template <bool RANK1>                                                               \
    __global__ void __launch_bounds__(FIELD_THREADS)                                    \
    name##_kernel(const u64* __restrict__ a, const u64* __restrict__ b,                 \
                  const u64* __restrict__ c, u64* __restrict__ out, u64 k,              \
                  FieldGeom g) {                                                        \
        field_loop<OP, RANK1>(a, b, c, out, k, g);                                      \
    }
FIELD_KERNEL(gl_mul, OP_MUL)
FIELD_KERNEL(gl_add, OP_ADD)
FIELD_KERNEL(gl_sub, OP_SUB)
FIELD_KERNEL(gl_mul_add, OP_MUL_ADD)
FIELD_KERNEL(gl_mul_small, OP_MUL_SMALL)
#undef FIELD_KERNEL

typedef void (*field_kernel_t)(const u64*, const u64*, const u64*, u64*, u64, FieldGeom);

extern "C" {

int field_geom_words() { return FIELD_GEOM_WORDS; }

// op: OP_MUL .. OP_MUL_SMALL; a, b, c: device pointers of the operands' first
// words (b unused by mul_small, c by all but mul_add; a null a reads 0);
// out: n fresh words; k: mul_small's constant; geom: FIELD_GEOM_WORDS host
// words, [n, rank, shape (FIELD_MAX_RANK), strides of a, b, c
// (FIELD_MAX_RANK each)], outer dim first, read before this returns.
int field_launch(int op, const void* a, const void* b, const void* c, void* out,
                 unsigned long long k, const long long* geom, void* stream) {
    FieldGeom g;
    g.n = geom[0];
    g.rank = geom[1];
    if (g.n <= 0) return 0;
    if (g.rank < 1 || g.rank > FIELD_MAX_RANK || op < OP_MUL || op > OP_MUL_SMALL)
        return (int)cudaErrorInvalidValue;
    for (int d = 0; d < FIELD_MAX_RANK; ++d) {
        g.shape[d] = geom[2 + d];
        for (int j = 0; j < 3; ++j) g.stride[j][d] = geom[2 + FIELD_MAX_RANK * (1 + j) + d];
    }
    static const field_kernel_t rank1[] = {gl_mul_kernel<true>, gl_add_kernel<true>,
                                           gl_sub_kernel<true>, gl_mul_add_kernel<true>,
                                           gl_mul_small_kernel<true>};
    static const field_kernel_t ranked[] = {gl_mul_kernel<false>, gl_add_kernel<false>,
                                            gl_sub_kernel<false>, gl_mul_add_kernel<false>,
                                            gl_mul_small_kernel<false>};
    const field_kernel_t kernel = (g.rank == 1 ? rank1 : ranked)[op];
    long long blocks = (g.n + FIELD_THREADS - 1) / FIELD_THREADS;
    if (blocks > FIELD_MAX_BLOCKS) blocks = FIELD_MAX_BLOCKS;
    kernel<<<(unsigned)blocks, FIELD_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)a, (const u64*)b, (const u64*)c, (u64*)out, (u64)k, g);
    return (int)cudaGetLastError();
}

}  // extern "C"
