// The radix-2 NTT / coset LDE over Goldilocks for NVIDIA Hopper (sm_90a):
// every ntt, intt, coset_fft, coset_ifft and coset_lde of ops/ntt.py on a
// CUDA tensor in one launch (n <= 2^t) or a few, where the plain version
// is a bit-reversal gather, three field launches and a stack a stage, and
// a canonicalisation.
//
//   ntt_tile    the bit-reversal load and stages 0 .. t-1 on tiles of 2^t
//               contiguous positions, in shared memory; the whole transform
//               when n <= 2^t
//   ntt_stride  a range of up to NTT_MAX_PASS_STAGES stages above t-1: the
//               2^L positions 2^s0 apart that the range pairs are a column
//               transform of their own, one thread's, in registers; one
//               launch takes stages t .. 16 (2^17 points), a transform of
//               any larger power of two one launch a range
//
// Neither replaces a TPU kernel: the JAX package computes the NTT as host C
// (svt_ntt_batch, svt_coset_lde_batch, native/svt_poseidon.c:754,813; the
// prover's default LDE backend) and as an XLA transform (ops/ntt_jax.py), no
// Pallas call. These are the card's counterparts of both.
//
// The words are the plain version's (ops/ntt.ntt_plain), not only equal mod
// p: radix-2 decimation in time, every butterfly b' = mul_gl(hi, w),
// (add_gl(lo, b'), sub_gl(lo, b')) with the plain version's twiddles (stage
// s at offset 2^s - 1 of one concatenated table of n - 1 words, as
// svt_ntt_batch lays it out), nothing canonicalised before the end. So the
// card and the CPU agree at every stage boundary.
//
// After a bit reversal, stages 0 .. t-1 pair positions inside a tile of 2^t:
// tile k (positions k 2^t + l) holds x[rev_t(l) 2^(bits-t) + rev(k)], words
// 2^(bits-t) apart. A block takes the tiles whose rev(k) are neighbours, so
// that a warp's loads cover whole sectors where the tiles fit in shared
// memory (NTT_SMEM_WORDS); below 2^t points a block takes several rows.
//
// The front (a flag): each input word times powers[i] (coset_fft, and
// coset_lde, which reads only the n_in coefficients a row). Where n_in <=
// 2^(bits - c), the bit-reversed load leaves every slot whose low c bits
// are not all 0 at 0, so DIT's stages 0 .. c-1 only pair a word with 0:
// mul_gl(0, w) = 0 and add_gl(a, 0) = sub_gl(a, 0) = a, the same words
// copied. ntt_tile makes those copies at the load (each coefficient into
// its 2^c neighbouring slots) and starts at stage c: an LDE of rate r
// skips r of its stages, with the plain version's words. The
// epilogue, in whichever kernel ends the transform: for ntt the canonical
// form; for intt output m is canonical(mul(canonical(c[(n - m) mod n]),
// n^-1)), and for coset_ifft that times shift^-m, canonicalised: the thread
// that holds c[k] writes position (n - k) mod n, so nothing is gathered.
//
// What bounds them: the operations, one field multiply, add and subtract a
// butterfly (19 integer instructions a point a stage, the LDE's copied
// stages left out), against 16 bytes a point read and written once a
// pass. Each pass reads and writes each word once. ntt_tile's twiddles
// come through L1 and L2; ntt_stride's stay in a thread's registers for
// all the rows it walks, and its next row's loads are in flight while it
// computes.
//
// Plain C interface (loaded with ctypes): no PyTorch headers, launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
#include "goldilocks.cuh"

#define NTT_TILE_THREADS 512
#define NTT_STRIDE_LOG_THREADS 8
#define NTT_STRIDE_THREADS (1 << NTT_STRIDE_LOG_THREADS)
#define NTT_SMEM_WORDS 8192              // 64 KB of dynamic shared memory
#define NTT_MAX_TILE_BITS 13
#define NTT_MAX_PASS_STAGES 5            // a column of 2^5 words in registers

enum { EPI_NONE = 0, EPI_FORWARD = 1, EPI_INVERSE = 2, EPI_INVERSE_COSET = 3 };

__device__ __forceinline__ long long brev(long long v, int bits) {
    return bits ? (long long)(__brevll((u64)v) >> (64 - bits)) : 0;
}

// Position p of row `row` as the transform's last pass leaves it: a raw
// word for the next pass, or the epilogue's form at its output position.
__device__ __forceinline__ void ntt_store(u64* out, long long row, long long n,
                                          long long p, u64 v, int epi, u64 n_inv,
                                          const u64* __restrict__ inv_powers) {
    u64* dst = out + row * n;
    if (epi == EPI_NONE) {
        dst[p] = v;
    } else if (epi == EPI_FORWARD) {
        dst[p] = canonical(v);
    } else {
        const long long m = (n - p) & (n - 1);
        u64 w = canonical(mul_gl(canonical(v), n_inv));
        if (epi == EPI_INVERSE_COSET) w = canonical(mul_gl(w, inv_powers[m]));
        dst[m] = w;
    }
}

// One block: `group` tiles of T = 2^tb positions (tile u = its row's tile
// rev(k) = u mod 2^(bits-tb)), loaded bit-reversed, stages `copies` ..
// tb-1 (the stages below `copies` only copy: each loaded word fills its
// 2^copies slots).
__global__ void __launch_bounds__(NTT_TILE_THREADS)
ntt_tile_kernel(const u64* __restrict__ in, long long in_row_stride, long long in_elem_stride,
                long long n_in, u64* __restrict__ out, const u64* __restrict__ tw,
                const u64* __restrict__ powers, const u64* __restrict__ inv_powers, u64 n_inv,
                int bits, int tb, int copies, int log_group, long long rows, int epi) {
    extern __shared__ u64 sm[];
    const int T = 1 << tb;
    const int sbits = bits - tb;                    // log2 of tiles a row
    const long long K = 1ll << sbits;
    const long long u0 = (long long)blockIdx.x << log_group;
    const long long total = rows << sbits;
    const int here = (int)min((long long)1 << log_group, total - u0);
    const int words = here << tb;
    const int lb = tb - copies;                     // log2 of the words a tile loads
    const long long n = 1ll << bits;
    for (int i = threadIdx.x; i < (here << lb); i += NTT_TILE_THREADS) {
        // neighbouring threads on neighbouring addresses: the tiles' (k > 1:
        // consecutive rev(k), one row) or a row's words (K = 1)
        int g, j;
        if (K == 1) {
            g = i >> lb;
            j = i & ((1 << lb) - 1);
        } else {
            g = i & ((1 << log_group) - 1);
            j = i >> log_group;
        }
        const long long u = u0 + g;
        const long long row = u >> sbits;
        const long long idx = ((long long)j << sbits) + (u & (K - 1));
        u64 v = 0;
        if (idx < n_in) {
            v = in[row * in_row_stride + idx * in_elem_stride];
            if (powers) v = mul_gl(v, powers[idx]);
        }
        // j < 2^lb: rev_tb(j)'s low `copies` bits are 0
        u64* slot = sm + (g << tb) + (int)brev(j, tb);
        for (int c = 0; c < (1 << copies); ++c) slot[c] = v;
    }
    __syncthreads();
    const int half = words >> 1;
    for (int s = copies; s < tb; ++s) {
        const int m = 1 << s;
        const u64* w = tw + (m - 1);
        for (int i = threadIdx.x; i < half; i += NTT_TILE_THREADS) {
            const int g = i >> (tb - 1);
            const int b = i & ((T >> 1) - 1);
            const int k = b & (m - 1);
            const int lo = (g << tb) + ((b >> s) << (s + 1)) + k;
            const u64 x = sm[lo];
            const u64 y = mul_gl(sm[lo + m], w[k]);
            sm[lo] = add_gl(x, y);
            sm[lo + m] = sub_gl(x, y);
        }
        __syncthreads();
    }
    const int tile_epi = sbits == 0 ? epi : EPI_NONE;
    for (int i = threadIdx.x; i < words; i += NTT_TILE_THREADS) {
        const int g = i >> tb;
        const long long u = u0 + g;
        const long long p = (brev(u & (K - 1), sbits) << tb) + (i & (T - 1));
        ntt_store(out, u >> sbits, n, p, sm[i], tile_epi, n_inv, inv_powers);
    }
}

// Stages s0 .. s0 + L - 1 (s0 >= the tile's bits): they pair positions
// 2^s0 apart and more, so column (h, r), the 2^L positions h 2^(s0+L) +
// q 2^s0 + r (q < 2^L), is a transform of its own, which one thread holds
// in registers: no shared memory, no barrier. Neighbouring threads take
// neighbouring r, so a warp's load or store of word q is 256 contiguous
// bytes (an inverse's, at (n - p) mod n, too). Stage s0 + s2's twiddle for
// the pair at q = j < 2^s2 is tw[2^(s0+s2) - 1 + j 2^s0 + r], the plain
// stage loop's: it depends on neither h nor the row, so a thread walks
// `rows_a_thread` consecutive rows of its column and the compiler loads
// the 2^L - 1 twiddles once, before the row loop. The next row's loads are
// issued before a row's butterflies. The thread reads and writes only its
// own words, so a pass may run in place.
// (tools/torch_ntt_alternatives.py measures the designs turned down: one
// row a thread, the twiddles in an array of registers or in shared memory,
// no prefetch, the epilogue as a template argument.)
template <int L>
__global__ void __launch_bounds__(NTT_STRIDE_THREADS)
ntt_stride_kernel(const u64* in, u64* out,              // may be one buffer
                  const u64* __restrict__ tw, const u64* __restrict__ inv_powers, u64 n_inv,
                  int bits, int s0, unsigned col_blocks, long long rows, int rows_a_thread,
                  int epi) {
    constexpr int Q = 1 << L;
    const long long n = 1ll << bits;
    const long long c = (long long)(blockIdx.x % col_blocks) * blockDim.x + threadIdx.x;
    if (c >= (n >> L)) return;
    const long long step = 1ll << s0;
    const long long r = c & (step - 1);
    const long long at = ((c >> s0) << (s0 + L)) + r;    // position of q = 0
    const long long row0 = (long long)(blockIdx.x / col_blocks) * rows_a_thread;
    const long long row1 = min(rows, row0 + rows_a_thread);
    u64 next[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) next[q] = in[row0 * n + at + q * step];
#pragma unroll 1
    for (long long row = row0; row < row1; ++row) {
        u64 v[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) v[q] = next[q];
        if (row + 1 < row1) {
#pragma unroll
            for (int q = 0; q < Q; ++q) next[q] = in[(row + 1) * n + at + q * step];
        }
#pragma unroll
        for (int s2 = 0; s2 < L; ++s2) {
            const int m = 1 << s2;
            const u64* w = tw + (step << s2) - 1 + r;
#pragma unroll
            for (int b = 0; b < Q / 2; ++b) {
                const int j = b & (m - 1);
                const int lo = ((b >> s2) << (s2 + 1)) + j;
                const u64 x = v[lo];
                const u64 y = mul_gl(v[lo + m], w[j * step]);
                v[lo] = add_gl(x, y);
                v[lo + m] = sub_gl(x, y);
            }
        }
#pragma unroll
        for (int q = 0; q < Q; ++q)
            ntt_store(out, row, n, at + q * step, v[q], epi, n_inv, inv_powers);
    }
}

typedef void (*stride_launch)(unsigned, int, cudaStream_t, const u64*, u64*, const u64*,
                              const u64*, u64, int, int, unsigned, long long, int, int);

template <int L>
static void launch_stride(unsigned blocks, int threads, cudaStream_t stream, const u64* in,
                          u64* out, const u64* tw, const u64* inv_powers, u64 n_inv, int bits,
                          int s0, unsigned col_blocks, long long rows, int rows_a_thread,
                          int epi) {
    ntt_stride_kernel<L><<<blocks, threads, 0, stream>>>(in, out, tw, inv_powers, n_inv, bits,
                                                         s0, col_blocks, rows, rows_a_thread,
                                                         epi);
}

// by stages - 1
static const stride_launch STRIDE_LAUNCH[NTT_MAX_PASS_STAGES] = {
    launch_stride<1>, launch_stride<2>, launch_stride<3>, launch_stride<4>, launch_stride<5>};

static int smem_opt_in(const void* kernel, int bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     bytes);
}

extern "C" {

int ntt_smem_words() { return NTT_SMEM_WORDS; }
int ntt_max_pass_stages() { return NTT_MAX_PASS_STAGES; }

// in: a row's words at in + row * in_row_stride + i * in_elem_stride, i <
// n_in (n_in <= 2^bits; the rest of the row reads 0); out: rows x 2^bits
// fresh words; tw: the 2^bits - 1 stage twiddles; powers: n_in words or
// null; inv_powers: 2^bits words (EPI_INVERSE_COSET) or null; 2^log_group
// tiles a block, dividing the rows' tiles (or any count when tb = bits).
int ntt_tile(const void* in, long long in_row_stride, long long in_elem_stride, long long n_in,
             void* out, const void* tw, const void* powers, const void* inv_powers,
             unsigned long long n_inv, int bits, int tb, int log_group, long long rows,
             int epi, void* stream) {
    if (rows <= 0) return 0;
    if (tb < 0 || tb > bits || tb > NTT_MAX_TILE_BITS || log_group < 0
        || (1 << (tb + log_group)) > NTT_SMEM_WORDS || epi < EPI_NONE || epi > EPI_INVERSE_COSET
        || n_in > (1ll << bits))
        return (int)cudaErrorInvalidValue;
    const long long total = rows << (bits - tb);
    const long long blocks = (total + (1ll << log_group) - 1) >> log_group;
    const int bytes = (8 << (tb + log_group));
    // the stages that only copy: n_in <= 2^(bits - copies)
    int copies = 0;
    while (copies < tb && (n_in << (copies + 1)) <= (1ll << bits)) ++copies;
    int err = smem_opt_in((const void*)ntt_tile_kernel, bytes);
    if (err) return err;
    ntt_tile_kernel<<<(unsigned)blocks, NTT_TILE_THREADS, bytes, (cudaStream_t)stream>>>(
        (const u64*)in, in_row_stride, in_elem_stride, n_in, (u64*)out, (const u64*)tw,
        (const u64*)powers, (const u64*)inv_powers, (u64)n_inv, bits, tb, copies, log_group, rows,
        epi);
    return (int)cudaGetLastError();
}

// in, out: rows x 2^bits words (the same buffer, or two for an inverse's
// last pass, whose epilogue stores to other columns); stages s0 .. s0 +
// stages - 1 (1 <= stages <= NTT_MAX_PASS_STAGES); 2^log_threads threads a
// block, each column of up to `rows_a_thread` consecutive rows.
int ntt_stride(const void* in, void* out, const void* tw, const void* inv_powers,
               unsigned long long n_inv, int bits, int s0, int stages, int log_threads,
               int rows_a_thread, long long rows, int epi, void* stream) {
    if (rows <= 0) return 0;
    if (s0 < 1 || stages < 1 || stages > NTT_MAX_PASS_STAGES || s0 + stages > bits
        || bits > 62 || log_threads < 5 || log_threads > NTT_STRIDE_LOG_THREADS
        || rows_a_thread < 1 || epi < EPI_NONE || epi > EPI_INVERSE_COSET)
        return (int)cudaErrorInvalidValue;
    const long long col_blocks = ((1ll << (bits - stages)) + (1ll << log_threads) - 1)
                                 >> log_threads;
    const long long blocks = col_blocks * ((rows + rows_a_thread - 1) / rows_a_thread);
    if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    STRIDE_LAUNCH[stages - 1]((unsigned)blocks, 1 << log_threads, (cudaStream_t)stream,
                              (const u64*)in, (u64*)out, (const u64*)tw, (const u64*)inv_powers,
                              (u64)n_inv, bits, s0, (unsigned)col_blocks, rows, rows_a_thread,
                              epi);
    return (int)cudaGetLastError();
}

}  // extern "C"
