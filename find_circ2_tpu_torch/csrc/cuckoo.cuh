// The cuckoo k-mer table of index/hashtable.py as the kernels of this
// directory read it: its layout and the bucket hash. A bucket row is
// SLOTS slots of LANES int32 lanes, one int4 a slot: (p12, s8 | cnt_f << 16
// | cnt_r << 23, pos_f, pos_r), positions uint32 bit patterns. Shared by
// csrc/exact_stats.cu (K-b) and csrc/classic_k1.cu (K-c + K-d).

#pragma once

#include <cstdint>

namespace fc2t {

// index/hashtable.py's table layout and hash constants.
constexpr int kSlots = 2, kLanes = 4;
static_assert(kLanes == 4, "a slot is one int4");
constexpr int kCntBits = 7;
constexpr unsigned kCntMask = (1u << kCntBits) - 1u;
constexpr unsigned kS8Mask = 0xffffu;
constexpr uint32_t kC1 = 0x9E3779B1u, kC2 = 0x85EBCA77u, kC3 = 0xC2B2AE3Du;
constexpr uint32_t kLargePos = 0xffffffffu;
// ops/anchor_align.py LARGE_MM: the mismatch level of no hit.
constexpr int kLargeMm = 255;

// index/hashtable.mix_hash on uint32 lanes, wrapping mod 2^32.
__device__ __forceinline__ uint32_t mix_hash(uint32_t p, uint32_t s,
                                             uint32_t salt) {
    const uint32_t k1 = (kC1 ^ salt) | 1u;
    const uint32_t k2 = (kC2 ^ (salt << 1)) | 1u;
    uint32_t h = (p * k1) ^ (s * k2) ^ salt;
    h = (h ^ (h >> 15)) * kC3;
    return h ^ (h >> 13);
}

// Whether slot `r` holds the canonical key (cp, cs).
__device__ __forceinline__ bool holds(int4 r, long long cp, uint32_t cs) {
    return (long long)r.x == cp && ((unsigned)r.y & kS8Mask) == cs;
}

}  // namespace fc2t
