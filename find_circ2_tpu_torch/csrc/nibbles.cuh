// Device helpers shared by the kernels of this directory: the
// nibble-packed genome of ops/packed.py (eight bases a 32-bit word, base i
// in bits 4 (i % 8) of word i / 8), chromosome lookup and the clamped
// window starts of the plain versions. Position arithmetic is uint32 and
// wraps where the plain code masks with & 0xFFFFFFFF.

#pragma once

#include <cstdint>

namespace fc2t {

// The complement of a base code; N and the padding codes stay.
__device__ __forceinline__ int comp(int x) { return x < 4 ? 3 - x : x; }

// searchsorted(offsets, x, right=True): the offsets <= x.
__device__ __forceinline__ int upper(const int64_t* off, int n,
                                     long long x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (off[mid] <= x)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

// Base t of a window starting at genome base s0, whose nibble words are
// w[0], w[1], ... from word s0 / 8 on.
__device__ __forceinline__ int window_base(const uint32_t* w, uint32_t s0,
                                           int t) {
    const uint32_t g = s0 + (uint32_t)t;
    return (int)((w[(g >> 3) - (s0 >> 3)] >> (4 * (g & 7))) & 7u);
}

// Bases t .. t+7 of such a window as nibbles, base t lowest.
__device__ __forceinline__ uint32_t nibbles(const uint32_t* w, uint32_t s0,
                                            int t) {
    const uint32_t g = s0 + (uint32_t)t;
    const uint32_t i = (g >> 3) - (s0 >> 3);
    return __funnelshift_r(w[i], w[i + 1], 4 * (g & 7)) & 0x77777777u;
}

// Bit 0 of each nibble: the read's base and the window's differ, or
// either is not A, C, G or T (code >= 4); bases at or past n (of 8): 0.
__device__ __forceinline__ uint32_t mismatches(uint32_t q, uint32_t g,
                                               int n) {
    const uint32_t x = q ^ g;
    const uint32_t m = (x | x >> 1 | x >> 2 | (q | g) >> 2) & 0x11111111u;
    return n >= 8 ? m : (n <= 0 ? 0u : m & ((1u << (4 * n)) - 1u));
}

// Bit 0 of each nibble: that base is `code`.
__device__ __forceinline__ uint32_t same(uint32_t w, int code) {
    const uint32_t y = w ^ ((uint32_t)code * 0x11111111u);
    return ~(y | y >> 1 | y >> 2) & 0x11111111u;
}

// The clamped window start of a candidate at `pos` (as the plain
// versions' torch.clamp(start, 0, max_start) on a masked uint32 start): a
// left piece reads G[pos : ...], a right piece G[pos+a-len-2 : ...]. A
// start that wraps below 0 clamps to the top.
__device__ __forceinline__ uint32_t window_start(bool left, uint32_t pos,
                                                 uint32_t al, int len,
                                                 uint32_t max_start) {
    const uint32_t start = left ? pos : pos + al - (uint32_t)len - 2u;
    return start < max_start ? start : max_start;
}

}  // namespace fc2t
