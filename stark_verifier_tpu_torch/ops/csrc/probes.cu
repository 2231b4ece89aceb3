// Rate probes for NVIDIA Hopper (sm_90a): what the card's integer and float
// pipes and its tensor cores sustain on the instructions the Poseidon kernels
// are made of.
//
// Replaces the two TPU kernels of tools/vpu_microbench.py: `_mk(...).run`
// (body `kernel`: chains of 512 dependent u32 / f32 ops on an [8, 512] tile,
// grid 64, an ALU-rate probe of the vector unit) -> alu_probe, and `run_mxu`
// (body `mxu_kernel`: an f32 [12, 12] @ [12, 8192] product chained 30 times,
// one per Poseidon round, a matrix-unit probe) -> mma_probe.
//
// What bounds them: alu_probe, operations, by design: it reads and writes one
// word an element and does `chain` (x `ilp`) steps on it in registers.
// mma_probe, bytes at the card's rates (30 products of 12 x 12 bytes a
// column are 8,640 int8 operations for 24 bytes moved): its tile stays in
// registers for all 30 products, and the loads and stores move 16 bytes a
// thread through a small per-warp stage in shared memory, once a tile. The
// TPU shapes would fill 4 of this card's 132 SMs, so the caller sizes the
// input to fill the card instead (at least 132 x 2048 threads).
//
// alu_probe. A compiler folds `y += x` 512 times into y + 512 * x and
// strength-reduces the rest, so every step is one `asm volatile` of the
// intended PTX. The assembler still picks the machine code, and it sees
// through the `asm`: it merges two add.u32 steps into one three-input add
// (so OP_ADD_U32 times the step, not one add), and at a 4-fold unroll it
// multiplies the mul_u32 chain by x^2 once every two steps. So the loops
// are checked by what they execute: ops/probes.py `step_sass` counts a
// step's machine instructions in the built library (cuobjdump), and
// tools/torch_alu_probe_alternatives.py holds this design against the
// ones it turned down, on the card. With ilp = 1 a thread runs one
// dependent chain (latency shows); with ilp = 4 it runs four independent
// ones (throughput shows). The chain loop is unrolled 64 times: at 8 its
// three instructions of control (counter, compare, branch) cost the
// one-chain loops up to a fifth of their time.
//
// mad_wide_u32 is one IMAD.WIDE.U32 a step with the 64-bit y as its
// addend, which is what the bound (chip_smoke.py) counts. Written as PTX
// `mad.wide.u32 y, lo, x, y`, ptxas splits it, at -O1 as at -O3, and
// whether the low word is cast before the `asm` or taken inside it: a
// product with RZ as its addend, the low add as IADD3, and the high words
// of two steps summed by one IADD3.X (2.5 instructions a step). Written as
// a product and a 64-bit add (`mul.wide.u32`, `add.u64`), the same
// function comes out fused. Measured on an H100 against mul_u32's IMAD,
// that instruction takes 2 issue slots of the IMAD pipe, but 2.5 where both
// its factors sit in even registers, beside the even low word of y that it
// also reads as its addend: so the step gains almost nothing over the split
// at an unroll of 8 to 32, where ptxas puts x in R0, and a fifth at 64, where
// it puts x in R5. ops/probes.py STEP_SASS holds that placement, and
// chip_smoke.py checks it in the built library. What is left to the bound,
// one slot a step, is the instruction's second slot.
//
// mul_lo_u64 is its least count: one wide product of the low words and the
// two cross products added into its high word by IMAD; `mul.lo.u64` came
// out with an extra three-input add, 6-9 % slower.
//
// mma_probe. y <- (M @ y) mod 256, 30 times, on bytes. The TPU's probe used
// random floats; this one is integer-valued because it times the product the
// Poseidon kernel runs, whose operands are 8-bit limbs: kind 0 through
// mma.sync m16n8k16 s32.u8.u8.s32 (the shape poseidon_gl_mma.cu uses), kind 1
// through the TF32 mma m16n8k8. The mod 256 keeps both exact: values < 256
// fit TF32's 11-bit significand, entries of M are < 64, so sums are
// < 12 * 63 * 255 < 2^18. Between two products the result stays in
// registers (the fragment plan is described above mma_probe_kernel).
//
// Plain C interface (loaded with ctypes): no PyTorch headers, launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef unsigned int u32;
typedef unsigned char u8;

// ------------------------------------------------------------- alu_probe
enum {
    OP_MUL_U32 = 0,       // y <- y * x                     mul.lo.u32
    OP_ADD_U32 = 1,       // y <- y + x                     add.u32
    OP_SHIFT_ADD_U32 = 2, // y <- (y >> 1) + x              shr.u32, add.u32
    OP_CMP_ADD_U32 = 3,   // y <- y + (y < x)               setp, selp, add
    OP_FMA_F32 = 4,       // y <- y * x + x                 fma.rn.f32
    OP_CVT_U32_F32 = 5,   // y <- u32(f32(y)) + x           cvt, cvt, add
    OP_MUL_LO_U64 = 6,    // y <- y * x (low 64 bits)       mul.lo.u64
    OP_MUL_HI_U64 = 7,    // y <- (y * x) >> 64             mul.hi.u64
    OP_MAD_WIDE_U32 = 8,  // y <- u32(y) * x + y (64-bit)   mad.wide.u32
};

template <int OP> struct Step;

template <> struct Step<OP_MUL_U32> {
    typedef u32 X; typedef u32 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(y) : "r"(x));
    }
};
template <> struct Step<OP_ADD_U32> {
    typedef u32 X; typedef u32 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("add.u32 %0, %0, %1;" : "+r"(y) : "r"(x));
    }
};
template <> struct Step<OP_SHIFT_ADD_U32> {
    typedef u32 X; typedef u32 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("{ .reg .u32 t; shr.u32 t, %0, 1; add.u32 %0, t, %1; }"
                     : "+r"(y) : "r"(x));
    }
};
template <> struct Step<OP_CMP_ADD_U32> {
    typedef u32 X; typedef u32 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("{ .reg .pred p; .reg .u32 t; setp.lt.u32 p, %0, %1; "
                     "selp.u32 t, 1, 0, p; add.u32 %0, %0, t; }"
                     : "+r"(y) : "r"(x));
    }
};
template <> struct Step<OP_FMA_F32> {
    typedef float X; typedef float Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + 0.125f * k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(y) : "f"(x));
    }
};
template <> struct Step<OP_CVT_U32_F32> {
    typedef u32 X; typedef u32 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    // u32 -> f32 rounds to nearest even; f32 -> u32 truncates and saturates
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("{ .reg .f32 f; .reg .u32 t; cvt.rn.f32.u32 f, %0; "
                     "cvt.rzi.u32.f32 t, f; add.u32 %0, t, %1; }"
                     : "+r"(y) : "r"(x));
    }
};
// The low word's wide product, the two cross products added into its high
// word: the least count (a `mul.lo.u64` gets an extra three-input add)
template <> struct Step<OP_MUL_LO_U64> {
    typedef u64 X; typedef u64 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("{ .reg .u32 al, ah, bl, bh, wl, wh; .reg .u64 w; "
                     "mov.b64 {al, ah}, %0; mov.b64 {bl, bh}, %1; mul.wide.u32 w, al, bl; "
                     "mov.b64 {wl, wh}, w; mad.lo.u32 wh, al, bh, wh; "
                     "mad.lo.u32 wh, ah, bl, wh; mov.b64 %0, {wl, wh}; }"
                     : "+l"(y) : "l"(x));
    }
};
template <> struct Step<OP_MUL_HI_U64> {
    typedef u64 X; typedef u64 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("mul.hi.u64 %0, %0, %1;" : "+l"(y) : "l"(x));
    }
};
// A product and a 64-bit add, which ptxas fuses into one IMAD.WIDE.U32 with
// the 64-bit y as its addend (a `mad.wide.u32` it splits: the note above)
template <> struct Step<OP_MAD_WIDE_U32> {
    typedef u32 X; typedef u64 Y;
    static __device__ __forceinline__ Y init(X x, int k) { return (u64)x + k; }
    static __device__ __forceinline__ void run(Y& y, X x) {
        asm volatile("{ .reg .u32 lo, hi; .reg .u64 t; mov.b64 {lo, hi}, %0; "
                     "mul.wide.u32 t, lo, %1; add.u64 %0, %0, t; }" : "+l"(y) : "r"(x));
    }
};

#define ALU_THREADS 256

template <int OP, int ILP>
__global__ void __launch_bounds__(ALU_THREADS)
alu_probe_kernel(const typename Step<OP>::X* __restrict__ x,
                 typename Step<OP>::Y* __restrict__ out, long long n, int chain) {
    typedef Step<OP> S;
    long long i = (long long)blockIdx.x * ALU_THREADS + threadIdx.x;
    if (i >= n) return;
    const typename S::X xv = x[i];
    typename S::Y y[ILP];
#pragma unroll
    for (int k = 0; k < ILP; ++k) y[k] = S::init(xv, k);
#pragma unroll 64
    for (int s = 0; s < chain; ++s) {
#pragma unroll
        for (int k = 0; k < ILP; ++k) S::run(y[k], xv);
    }
    typename S::Y r = y[0];
#pragma unroll
    for (int k = 1; k < ILP; ++k) r += y[k];   // wraps for the integer types
    out[i] = r;
}

template <int OP>
static int launch_alu(int ilp, const void* x, void* out, long long n, int chain,
                      cudaStream_t stream) {
    typedef Step<OP> S;
    unsigned blocks = (unsigned)((n + ALU_THREADS - 1) / ALU_THREADS);
    const typename S::X* xp = (const typename S::X*)x;
    typename S::Y* op = (typename S::Y*)out;
    if (ilp == 1)
        alu_probe_kernel<OP, 1><<<blocks, ALU_THREADS, 0, stream>>>(xp, op, n, chain);
    else if (ilp == 4)
        alu_probe_kernel<OP, 4><<<blocks, ALU_THREADS, 0, stream>>>(xp, op, n, chain);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------- mma_probe
// The product is taken transposed: y'^T = y^T M^T, with y^T as the A operand
// (16 columns of y a tile are A's 16 rows m; y's rows are A's depth k) and
// M^T as B (two n8 tiles cover y''s rows 0..7 and 8..15; rows 12..15 are
// zero padding). Depth slot k of A carries y's row K_ROW(k), chosen so that
// what a thread holds of D (rows m = t/4 and t/4 + 8, n = 2(t%4), +1 of each
// n tile) is exactly what it needs of the next A: the D -> A step is local
// to the thread, with no shuffle and no shared memory. M^T's rows are
// permuted the same way, so the product is unchanged.
//   u8, m16n8k16: A slot (m, 4(t%4) + i) <- y row {2q, 2q+1, 2q+8, 2q+9}[i]
//     (q = t%4); the next a0 = low bytes of D0.d0, D0.d1, D1.d0, D1.d1,
//     a1 = those of D0.d2, D0.d3, D1.d2, D1.d3.
//   tf32, m16n8k8 twice along k: slot q of k tile h <- y row 8h + 2q, slot
//     q + 4 <- 8h + 2q + 1; the next A of k tile h is D_h's d0, d2, d1, d3,
//     each taken mod 256 in float (exact: values below 2^18).
// tests/test_torch_probes.py restates this plan in Python and emulates the
// 30 products through it, lane by lane, against mma_plain.
#define MMA_BLOCK_COLS 8192
#define MMA_THREADS 256                       // 8 warps, 1024 columns each
#define MMA_WARP_COLS (MMA_BLOCK_COLS / (MMA_THREADS / 32))
// tiles of 16 columns in flight a warp: 8 for u8, 4 for tf32 (whose eight
// fragment registers a tile would spill at 8 under the register cap)
#define MAX_GROUP_COLS (16 * 8)
#define STAGE_BYTES (12 * MAX_GROUP_COLS)     // a group's 12 rows, row-major

// not volatile: the products are pure, so the compiler may interleave them
__device__ __forceinline__ void mma_u8(int (&d)[4], u32 a0, u32 a1, u32 b) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a0), "r"(a1), "r"(b), "r"(0));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const u32 (&a)[4],
                                         u32 b0, u32 b1, const float (&c)[4]) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// y's row carried by depth slot i (0..3) of thread column q, u8 kind
__device__ __forceinline__ int k_row_u8(int q, int i) {
    return 2 * q + (i & 1) + 8 * (i >> 1);
}

__device__ __forceinline__ u32 m_entry(const u8* M, int row, int col) {
    return (row < 12 && col < 12) ? (u32)M[row * 12 + col] : 0u;
}

template <int GROUP_COLS>
__device__ __forceinline__ u32 stage_byte(const u8* stage, int row, int col) {
    return row < 12 ? (u32)stage[row * GROUP_COLS + col] : 0u;
}

// the low bytes of four words, x0 lowest
__device__ __forceinline__ u32 low_bytes(int x0, int x1, int x2, int x3) {
    u32 lo = __byte_perm((u32)x0, (u32)x1, 0x0040);
    u32 hi = __byte_perm((u32)x2, (u32)x3, 0x0040);
    return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ float mod256(float v) {
    return fmaf(-256.0f, floorf(v * (1.0f / 256.0f)), v);
}

// KIND 0: u8 mma; KIND 1: tf32 mma. y, out: u8[12, N], N % 8192 == 0, both
// 16-byte aligned; M: u8[12, 12].
template <int KIND>
__global__ void __launch_bounds__(MMA_THREADS, 4)
mma_probe_kernel(const u8* __restrict__ y, const u8* __restrict__ M,
                 u8* __restrict__ out, long long N, int steps) {
    constexpr int GROUP_TILES = KIND == 0 ? 8 : 4;
    constexpr int GROUP_COLS = 16 * GROUP_TILES;
    __shared__ __align__(16) u8 smem[(MMA_THREADS / 32) * STAGE_BYTES];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int grp = lane >> 2, q = lane & 3;
    u8* stage = smem + warp * STAGE_BYTES;

    // B = M^T with its depth permuted as A's, for n tiles j = 0, 1
    u32 b_u8[2] = {0u, 0u};
    u32 b_tf[2][2][2];                        // [k tile h][n tile j][b0, b1]
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        if (KIND == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
                b_u8[j] |= m_entry(M, 8 * j + grp, k_row_u8(q, i)) << (8 * i);
        } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                b_tf[h][j][0] = __float_as_uint((float)m_entry(M, 8 * j + grp, 8 * h + 2 * q));
                b_tf[h][j][1] = __float_as_uint((float)m_entry(M, 8 * j + grp, 8 * h + 2 * q + 1));
            }
        }
    }

    const long long warp_base =
        (long long)blockIdx.x * MMA_BLOCK_COLS + (long long)warp * MMA_WARP_COLS;
    for (int group = 0; group < MMA_WARP_COLS / GROUP_COLS; ++group) {
        const long long base = warp_base + (long long)group * GROUP_COLS;
        // 12 rows x 64 columns in, 16 bytes a thread, into the warp's stage
        for (int v = lane; v < 12 * GROUP_COLS / 16; v += 32) {
            int row = v / (GROUP_COLS / 16), chunk = v % (GROUP_COLS / 16);
            *reinterpret_cast<uint4*>(stage + row * GROUP_COLS + 16 * chunk) =
                *reinterpret_cast<const uint4*>(y + row * N + base + 16 * chunk);
        }
        __syncwarp();
        u32 a_u8[GROUP_TILES][2];
        u32 a_tf[GROUP_TILES][2][4];
#pragma unroll
        for (int t = 0; t < GROUP_TILES; ++t) {
            const int c = 16 * t + grp;
            if (KIND == 0) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    a_u8[t][r] = 0u;
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        a_u8[t][r] |= stage_byte<GROUP_COLS>(stage, k_row_u8(q, i), c + 8 * r) << (8 * i);
                }
            } else {
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        a_tf[t][h][e] = __float_as_uint((float)stage_byte<GROUP_COLS>(
                            stage, 8 * h + 2 * q + (e >> 1), c + 8 * (e & 1)));
            }
        }
#pragma unroll 1
        for (int s = 0; s < steps; ++s) {
            if (KIND == 0) {
                // every tile's two products first, then the packing
                int d[GROUP_TILES][2][4];
#pragma unroll
                for (int t = 0; t < GROUP_TILES; ++t)
#pragma unroll
                    for (int j = 0; j < 2; ++j)
                        mma_u8(d[t][j], a_u8[t][0], a_u8[t][1], b_u8[j]);
#pragma unroll
                for (int t = 0; t < GROUP_TILES; ++t) {
                    a_u8[t][0] = low_bytes(d[t][0][0], d[t][0][1], d[t][1][0], d[t][1][1]);
                    a_u8[t][1] = low_bytes(d[t][0][2], d[t][0][3], d[t][1][2], d[t][1][3]);
                }
                continue;
            }
            const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int t = 0; t < GROUP_TILES; ++t) {
                float d[2][4];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    float part[4];
                    mma_tf32(part, a_tf[t][0], b_tf[0][j][0], b_tf[0][j][1], zero);
                    mma_tf32(d[j], a_tf[t][1], b_tf[1][j][0], b_tf[1][j][1], part);
                }
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    a_tf[t][j][0] = __float_as_uint(mod256(d[j][0]));
                    a_tf[t][j][1] = __float_as_uint(mod256(d[j][2]));
                    a_tf[t][j][2] = __float_as_uint(mod256(d[j][1]));
                    a_tf[t][j][3] = __float_as_uint(mod256(d[j][3]));
                }
            }
        }
        __syncwarp();   // every thread has read the stage before it is rewritten
#pragma unroll
        for (int t = 0; t < GROUP_TILES; ++t) {
            const int c = 16 * t + grp;
            if (KIND == 0) {
#pragma unroll
                for (int r = 0; r < 2; ++r)
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        int row = k_row_u8(q, i);
                        if (row < 12)
                            stage[row * GROUP_COLS + c + 8 * r] = (u8)(a_u8[t][r] >> (8 * i));
                    }
            } else {
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        int row = 8 * h + 2 * q + (e >> 1);
                        if (row < 12)
                            stage[row * GROUP_COLS + c + 8 * (e & 1)] =
                                (u8)(int)__uint_as_float(a_tf[t][h][e]);
                    }
            }
        }
        __syncwarp();
        for (int v = lane; v < 12 * GROUP_COLS / 16; v += 32) {
            int row = v / (GROUP_COLS / 16), chunk = v % (GROUP_COLS / 16);
            *reinterpret_cast<uint4*>(out + row * N + base + 16 * chunk) =
                *reinterpret_cast<const uint4*>(stage + row * GROUP_COLS + 16 * chunk);
        }
        __syncwarp();   // the stores have read the stage before the next group
    }
}

extern "C" {

// x, out: device pointers to n contiguous elements (u32 or f32 in and out;
// u64 in and out for ops 6 and 7; u32 in and u64 out for op 8).
int alu_probe(int op, int ilp, const void* x, void* out, long long n, int chain,
              void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (op) {
        case OP_MUL_U32: return launch_alu<OP_MUL_U32>(ilp, x, out, n, chain, s);
        case OP_ADD_U32: return launch_alu<OP_ADD_U32>(ilp, x, out, n, chain, s);
        case OP_SHIFT_ADD_U32: return launch_alu<OP_SHIFT_ADD_U32>(ilp, x, out, n, chain, s);
        case OP_CMP_ADD_U32: return launch_alu<OP_CMP_ADD_U32>(ilp, x, out, n, chain, s);
        case OP_FMA_F32: return launch_alu<OP_FMA_F32>(ilp, x, out, n, chain, s);
        case OP_CVT_U32_F32: return launch_alu<OP_CVT_U32_F32>(ilp, x, out, n, chain, s);
        case OP_MUL_LO_U64: return launch_alu<OP_MUL_LO_U64>(ilp, x, out, n, chain, s);
        case OP_MUL_HI_U64: return launch_alu<OP_MUL_HI_U64>(ilp, x, out, n, chain, s);
        case OP_MAD_WIDE_U32: return launch_alu<OP_MAD_WIDE_U32>(ilp, x, out, n, chain, s);
    }
    return (int)cudaErrorInvalidValue;
}

// y, out: device pointers to u8[12, N], N a positive multiple of 8192, both
// 16-byte aligned;
// M: device pointer to u8[12, 12]; kind 0 = u8 mma, 1 = tf32 mma.
int mma_probe(int kind, const void* y, const void* M, void* out, long long N,
              int steps, void* stream) {
    if (N <= 0 || N % MMA_BLOCK_COLS != 0) return (int)cudaErrorInvalidValue;
    unsigned blocks = (unsigned)(N / MMA_BLOCK_COLS);
    cudaStream_t s = (cudaStream_t)stream;
    if (kind == 0)
        mma_probe_kernel<0><<<blocks, MMA_THREADS, 0, s>>>(
            (const u8*)y, (const u8*)M, (u8*)out, N, steps);
    else if (kind == 1)
        mma_probe_kernel<1><<<blocks, MMA_THREADS, 0, s>>>(
            (const u8*)y, (const u8*)M, (u8*)out, N, steps);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

}  // extern "C"
