// BN254 scalar-field (Fr) arithmetic for one thread, on ten 28-bit limbs.
//
// An element is u32 l[10], value = sum l[k] 2^(28 k), in Montgomery form
// with R = 2^280. A product of two limbs is one IMAD.WIDE.U32 (32 x 32 + 64
// -> 64 bits), and the products of a column are summed in a 64-bit
// accumulator with no carry to detect: on 64-bit words every carry is a
// compare and a select. R is 2^26 times q, which leaves room for laziness:
//   * an element is *normalized*: every limb below 2^28 + 2^9 and the value
//     below 2^262, not necessarily below q. No operation subtracts q; only
//     fr_canonical, on the way out, does;
//   * fr_add adds limbwise, without carries: limbs below 2^29 + 2^10, a
//     value below 2^263. Its result only feeds a product (the s-box);
//   * fr_dot(a, b) = (sum_n a[n] b[n] + m q) / R, with m < R chosen so that
//     R divides the numerator (m = -sum / q mod R, one 28-bit digit a step,
//     the reduction interleaved with the products, FIOS order): a 64-bit
//     accumulator a column, about ten of them live at a time. Bounds, for
//     at most five products whose operands have limbs below 2^29 + 2^10 on
//     one side and 2^28 + 2^9 on the other, or below 2^29 + 2^10 on both
//     sides for one product: a column holds at most 50 limb products
//     (below 2^57.1 each, or 10 below 2^58.1), 10 digit products m_i q_j
//     (below 2^56) and a carry below 2^36: below 2^63 < 2^64. The result is
//     below sum / R + q < 5 2^263 2^262 / 2^280 + q < 2^248 + q: normalized
//     again after one carry pass;
//   * fr_dot_add(a, b, s) = fr_dot(a, b) + s for a normalized s: the value
//     grows by less than q + 2^248 a call. The bridge adds this way 60
//     times into the same lane, so its values stay below 62 q < 2^260.
// -q^-1 mod 2^28 = 2^28 - 1 (q = 1 mod 2^28), so a step's digit is
// m = -t0 mod 2^28, and m q_0 = m.
#pragma once
#include "goldilocks.cuh"

#define FR_NL 10                 // limbs
#define FR_LB 28                 // bits a limb
#define FR_LMASK 0x0FFFFFFFu
// q = 21888242871839275222246405745257275088548364400416034343698204186575808495617
// in 28-bit limbs, least significant first
#define FR_Q_L0 0x0000001u
#define FR_Q_L1 0xe1f593fu
#define FR_Q_L2 0x9709143u
#define FR_Q_L3 0xe84879bu
#define FR_Q_L4 0x85d2833u
#define FR_Q_L5 0xb681815u
#define FR_Q_L6 0x9b85045u
#define FR_Q_L7 0xe131a02u
#define FR_Q_L8 0x0644e72u
#define FR_Q_L9 0x0000003u
// R^2 mod q = 2^560 mod q (into Montgomery form: a product with it)
#define FR_R2_L0 0xf4ec6b4u
#define FR_R2_L1 0x9b2c977u
#define FR_R2_L2 0x8aa70ffu
#define FR_R2_L3 0x88742bbu
#define FR_R2_L4 0xae1fcf6u
#define FR_R2_L5 0xff538b3u
#define FR_R2_L6 0xbf33da0u
#define FR_R2_L7 0xa1d99a8u
#define FR_R2_L8 0xa45a5a6u
#define FR_R2_L9 0x0000000u

struct fr {
    u32 l[FR_NL];
};

__device__ __forceinline__ u32 fr_q(int k) {
    return k == 0 ? FR_Q_L0 : k == 1 ? FR_Q_L1 : k == 2 ? FR_Q_L2
         : k == 3 ? FR_Q_L3 : k == 4 ? FR_Q_L4 : k == 5 ? FR_Q_L5
         : k == 6 ? FR_Q_L6 : k == 7 ? FR_Q_L7 : k == 8 ? FR_Q_L8 : FR_Q_L9;
}

// x + y * z + c as a 128-bit value: returns the low word, leaves the high
// word in c. Cannot overflow: (2^64 - 1)^2 + 2 (2^64 - 1) = 2^128 - 1.
// (64-bit words: the packing and unpacking around the permutation.)
__device__ __forceinline__ u64 mac(u64 x, u64 y, u64 z, u64& c) {
    u64 lo = y * z;
    u64 hi = __umul64hi(y, z);
    lo += x;
    hi += (lo < x) ? 1ull : 0ull;
    lo += c;
    hi += (lo < c) ? 1ull : 0ull;
    c = hi;
    return lo;
}

// t += a b, one mad.wide.u32. Inline PTX on purpose: written as C, the
// thousands of unrolled multiply-adds of a permutation form one expression
// graph deep enough to overflow the front end's stack (cicc) at -O3; an asm
// statement is opaque to it, and ptxas schedules the flat PTX.
__device__ __forceinline__ void mad_wide(u64& t, u32 a, u32 b) {
    asm("mad.wide.u32 %0, %1, %2, %0;" : "+l"(t) : "r"(a), "r"(b));
}

// limbwise, no carries (see the bounds above)
__device__ __forceinline__ fr fr_add(const fr& a, const fr& b) {
    fr r;
#pragma unroll
    for (int k = 0; k < FR_NL; ++k) r.l[k] = a.l[k] + b.l[k];
    return r;
}

// the high half of the accumulators after the last step (t[0..9], columns
// 10..19), plus s, carried into limbs below 2^28 (the top limb takes the
// rest; the value bound keeps it small)
__device__ __forceinline__ fr fr_carry(u64* t, const fr& s) {
    fr r;
#pragma unroll
    for (int k = 0; k < FR_NL - 1; ++k) {
        t[k] += s.l[k];
        r.l[k] = (u32)t[k] & FR_LMASK;
        t[k + 1] += t[k] >> FR_LB;
    }
    r.l[FR_NL - 1] = (u32)(t[FR_NL - 1] + s.l[FR_NL - 1]);
    return r;
}

// (sum_n a[n] b[n] + m q) / R + s: products and reduction interleaved
// (FIOS order: step i adds the products of limb i, then zeroes column i
// with its digit and carries its top into column i + 1), one 64-bit
// accumulator a column; columns below i are dead and those above i + 9
// untouched at step i, so ten or eleven are live at a time
template <int N>
__device__ __forceinline__ fr fr_dot_add(const fr (&a)[N], const fr (&b)[N],
                                         const fr& s) {
    u64 t[2 * FR_NL];
#pragma unroll
    for (int j = 0; j < 2 * FR_NL; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < FR_NL; ++i) {
#pragma unroll
        for (int n = 0; n < N; ++n)
#pragma unroll
            for (int j = 0; j < FR_NL; ++j) mad_wide(t[i + j], a[n].l[i], b[n].l[j]);
        const u32 m = (0u - (u32)t[i]) & FR_LMASK;
        t[i] += m;                                  // m q_0, q_0 = 1
#pragma unroll
        for (int j = 1; j < FR_NL; ++j) mad_wide(t[i + j], m, fr_q(j));
        t[i + 1] += t[i] >> FR_LB;                  // t[i] is a multiple of 2^28
    }
    return fr_carry(t + FR_NL, s);
}

template <int N>
__device__ __forceinline__ fr fr_dot(const fr (&a)[N], const fr (&b)[N]) {
    const fr zero = {{0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
    return fr_dot_add<N>(a, b, zero);
}

// a^2 R^-1 (mod q), normalized: fr_dot of one product, with each cross
// product a_i a_j (i < j) taken once, doubled, at step i: 55 limb products,
// not 100. Column c receives its pairs (k, c - k) at steps k <= c / 2, so
// it is complete before step c reduces it. For limbs below 2^29 + 2^10 a
// column holds at most 5 doubled products below 2^59.1, one square, 10
// digit products and a carry: below 2^62.
__device__ __forceinline__ fr fr_sqr(const fr& a) {
    u64 t[2 * FR_NL];
#pragma unroll
    for (int j = 0; j < 2 * FR_NL; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < FR_NL; ++i) {
        mad_wide(t[2 * i], a.l[i], a.l[i]);
        const u32 twice = a.l[i] << 1;
#pragma unroll
        for (int j = i + 1; j < FR_NL; ++j) mad_wide(t[i + j], twice, a.l[j]);
        const u32 m = (0u - (u32)t[i]) & FR_LMASK;
        t[i] += m;
#pragma unroll
        for (int j = 1; j < FR_NL; ++j) mad_wide(t[i + j], m, fr_q(j));
        t[i + 1] += t[i] >> FR_LB;
    }
    const fr zero = {{0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
    return fr_carry(t + FR_NL, zero);
}

// a b R^-1 (mod q), normalized
__device__ __forceinline__ fr fr_mont_mul(const fr& a, const fr& b) {
    const fr x[1] = {a}, y[1] = {b};
    return fr_dot<1>(x, y);
}

// the canonical value (below q) of a normalized x below 2q, carried fully
__device__ __forceinline__ fr fr_canonical(fr x) {
    u32 c = 0;
#pragma unroll
    for (int k = 0; k < FR_NL; ++k) {       // limbs below 2^28 exactly
        u32 v = x.l[k] + c;
        x.l[k] = v & FR_LMASK;
        c = v >> FR_LB;
    }
    fr d;
    int borrow = 0;
#pragma unroll
    for (int k = 0; k < FR_NL; ++k) {
        int v = (int)x.l[k] - (int)fr_q(k) - borrow;
        borrow = v < 0;
        d.l[k] = (u32)v & FR_LMASK;
    }
    return borrow ? x : d;                  // x - q if x >= q
}

// four 64-bit words (a value below 2^256) <-> ten limbs
__device__ __forceinline__ fr fr_from_words(const u64 (&w)[4]) {
    fr r;
#pragma unroll
    for (int k = 0; k < FR_NL; ++k) {
        const int bit = FR_LB * k, word = bit / 64, off = bit % 64;
        u64 v = w[word] >> off;
        if (off > 64 - FR_LB && word < 3) v |= w[word + 1] << (64 - off);
        r.l[k] = (u32)v & FR_LMASK;
    }
    return r;
}

// for limbs below 2^28 (a canonical value)
__device__ __forceinline__ void fr_to_words(const fr& x, u64 (&w)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = 0;
#pragma unroll
    for (int k = 0; k < FR_NL; ++k) {
        const int bit = FR_LB * k, word = bit / 64, off = bit % 64;
        w[word] |= (u64)x.l[k] << off;
        if (off > 64 - FR_LB && word < 3) w[word + 1] |= (u64)x.l[k] >> (64 - off);
    }
}
