// The cuckoo k-mer table of index/hashtable.py as the kernels of this
// directory read it: its layout, the bucket hash and an anchor's exact
// key. A bucket row is SLOTS slots of LANES int32 lanes, one int4 a slot:
// (p12, s8 | cnt_f << 16 | cnt_r << 23, pos_f, pos_r), positions uint32
// bit patterns. Shared by csrc/exact_stats.cu (K-b), csrc/classic_k1.cu
// (K-c + K-d) and csrc/shard_finish.cuh (the cross-shard finish).

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

// The longest anchor whose exact key is one 64-bit number.
constexpr int kMaxKeyLen = 32;

// The anchor's codes as one base-4 number, code j (those >= 4 as 0) the
// digit of 4^(al - 1 - j), and whether every code is below 4. An anchor
// row on 4 bytes of a length that is a multiple of 4 is read as words,
// all in flight at once; any other byte by byte.
__device__ __forceinline__ unsigned long long forward(const uint8_t* anc,
                                                      int al, bool& clean) {
    unsigned long long f = 0;
    bool ok = true;
    if ((al & 3) == 0 && (reinterpret_cast<uintptr_t>(anc) & 3) == 0) {
        const auto* w = reinterpret_cast<const uint32_t*>(anc);
        const int nw = al >> 2;
        uint32_t x[kMaxKeyLen / 4];
#pragma unroll
        for (int t = 0; t < kMaxKeyLen / 4; ++t)
            x[t] = t < nw ? __ldg(w + t) : 0u;
#pragma unroll
        for (int t = 0; t < kMaxKeyLen / 4; ++t) {
            if (t < nw) {
                // 0xff in each byte whose code is below 4.
                const uint32_t lt = __vcmpltu4(x[t], 0x04040404u);
                ok = ok && lt == 0xffffffffu;
                const uint32_t q = x[t] & lt;
                f = f << 8 | (q << 6 & 0xc0u) | (q >> 4 & 0x30u) |
                    (q >> 14 & 0x0cu) | (q >> 24 & 0x03u);
            }
        }
    } else {
        for (int j = 0; j < al; ++j) {
            const unsigned c = anc[j];
            ok = ok && c < 4;
            f = f << 2 | (c < 4 ? c : 0u);
        }
    }
    clean = ok;
    return f;
}

// The reverse complement's number: the digits complemented, in reverse
// order.
__device__ __forceinline__ unsigned long long reverse_complement(
    unsigned long long f, int al) {
    const unsigned long long all =
        al == 32 ? ~0ull : (1ull << (2 * al)) - 1ull;
    constexpr unsigned long long kEven = 0x5555555555555555ull;
    unsigned long long r = __brevll(~f & all);
    r = (r >> 1 & kEven) | (r & kEven) << 1;  // each digit's bits back
    return r >> (64 - 2 * al);
}

// The canonical exact key of an anchor of `al` codes whose prefix key
// takes `pk` of them (ops/anchor_align._exact_keys): (cp, cs), `swap`
// (the reverse complement's key is the smaller) and `clean`.
struct ExactKey {
    unsigned long long cp, cs;
    bool swap, clean;
};

__device__ __forceinline__ ExactKey exact_key(const uint8_t* anc, int al,
                                              int pk) {
    ExactKey k;
    const int sk = al - pk;
    const unsigned long long f = forward(anc, al, k.clean);
    const unsigned long long r = reverse_complement(f, al);
    const unsigned long long low = (1ull << (2 * sk)) - 1ull;
    const unsigned long long p12 = f >> (2 * sk), s8 = f & low;
    const unsigned long long p12r = r >> (2 * sk), s8r = r & low;
    k.swap = p12r < p12 || (p12r == p12 && s8r < s8);
    k.cp = k.swap ? p12r : p12;
    k.cs = k.swap ? s8r : s8;
    return k;
}

}  // namespace fc2t
