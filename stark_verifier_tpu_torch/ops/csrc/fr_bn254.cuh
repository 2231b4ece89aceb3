// BN254 scalar-field (Fr) arithmetic for one thread: an element is four
// 64-bit words, least significant first, kept canonical (below q) between
// operations. Multiplication is Montgomery (R = 2^256) by CIOS, with the
// high words of the 64 x 64 products from __umul64hi; every add and every
// product ends in one conditional subtraction of q, which is exact because
// both operands are canonical (then the sum, or the CIOS result, is below
// 2q). The word-level algorithm is that of native/svt_bn254.c
// (fr_mont_mul, fr_add), so the two agree bit for bit.
#pragma once
#include "goldilocks.cuh"

// q = 21888242871839275222246405745257275088548364400416034343698204186575808495617
#define FR_Q0 0x43e1f593f0000001ull
#define FR_Q1 0x2833e84879b97091ull
#define FR_Q2 0xb85045b68181585dull
#define FR_Q3 0x30644e72e131a029ull
// -q^-1 mod 2^64
#define FR_QINV 0xc2e1f593efffffffull
// R^2 mod q = 2^512 mod q (to_mont is a Montgomery product with it)
#define FR_R2_0 0x1bb8e645ae216da7ull
#define FR_R2_1 0x53fe3ab1e35c59e3ull
#define FR_R2_2 0x8c49833d53bb8085ull
#define FR_R2_3 0x0216d0b17f4e44a5ull

struct fr {
    u64 l[4];
};

__device__ __forceinline__ u64 fr_q(int i) {
    return i == 0 ? FR_Q0 : i == 1 ? FR_Q1 : i == 2 ? FR_Q2 : FR_Q3;
}

// x + y * z + c as a 128-bit value: returns the low word, leaves the high
// word in c. Cannot overflow: (2^64 - 1)^2 + 2 (2^64 - 1) = 2^128 - 1.
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

// a - q if a >= q (a below 2^256); a otherwise. Branch-free: the borrow out
// of a - q says which.
__device__ __forceinline__ void fr_cond_sub_q(fr& a) {
    u64 d[4], borrow = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        u64 q = fr_q(i);
        u64 t = a.l[i] - q;
        u64 b1 = (a.l[i] < q) ? 1ull : 0ull;
        d[i] = t - borrow;
        borrow = b1 | ((t < borrow) ? 1ull : 0ull);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) a.l[i] = borrow ? a.l[i] : d[i];
}

// a + b mod q for canonical a, b: a + b < 2q < 2^255, so no carry leaves
// the top word.
__device__ __forceinline__ fr fr_add(const fr& a, const fr& b) {
    fr s;
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        u64 t = a.l[i] + c;
        u64 c1 = (t < c) ? 1ull : 0ull;
        s.l[i] = t + b.l[i];
        c = c1 + ((s.l[i] < t) ? 1ull : 0ull);
    }
    fr_cond_sub_q(s);
    return s;
}

// a b R^-1 mod q for canonical a, b (CIOS: four rounds of t += a_i b, then
// t = (t + m q) / 2^64 with m = t_0 (-q^-1) mod 2^64). The result before
// the subtraction is below 2q, so t[4] ends 0 and one subtraction makes it
// canonical.
__device__ __forceinline__ fr fr_mont_mul(const fr& a, const fr& b) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        u64 c = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) t[j] = mac(t[j], a.l[i], b.l[j], c);
        u64 s = t[4] + c;
        t[5] = (s < c) ? 1ull : 0ull;
        t[4] = s;

        u64 m = t[0] * FR_QINV;
        c = 0;
        mac(t[0], m, FR_Q0, c);  // the low word is 0 by the choice of m
#pragma unroll
        for (int j = 1; j < 4; ++j) t[j - 1] = mac(t[j], m, fr_q(j), c);
        s = t[4] + c;
        t[3] = s;
        t[4] = t[5] + ((s < c) ? 1ull : 0ull);
    }
    fr r = {{t[0], t[1], t[2], t[3]}};
    fr_cond_sub_q(r);
    return r;
}
