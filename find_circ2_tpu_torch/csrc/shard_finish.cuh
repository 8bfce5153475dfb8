// What the sharded K1's record kernels share: the records' widths, the
// loads of the other shards' records, and the enumeration's cross-shard
// combine and finish, the epilogue of csrc/classic_k1.cu's combining
// mode. (csrc/exact_stats.cu's combining mode folds the probe's records
// into its own partials and runs the single table's finish on them.) The
// plain versions are ops/anchor_align.py's shard_finish_ref: _combine,
// then finalize_hits with _hits (classic records).
//
// A record is a shard's int32 partials of one anchor or slot: nine
// fields for the probe (ops/anchor_align.EXACT_OPS' order), eight for
// the enumeration (CLASSIC_OPS'). Counts add, in 64 bits. Positions are
// uint32 bit patterns and take the least as unsigned numbers.
//
// Kept bit for bit: the classic records come guarded per shard, as
// candidate_stats guards; a position is taken only where its count is
// above 0 (csrc/classic_k1.cu masks the records so).

#pragma once

#include <cstdint>

#include "cuckoo.cuh"

namespace fc2t {

// The record widths of the partials modes (ops/anchor_align
// EXACT_FIELDS, CLASSIC_FIELDS) and the most index shards a combine
// takes (ops/anchor_align.MAX_SHARDS, the mesh's index axis).
constexpr int kExactFields = 9, kClassicFields = 8;
constexpr int kMaxShards = 64;

// Classic records combined: the counts of the exact slots 0 and V, each
// strand half's count, the least first positions of slot 0, slot V,
// slots 1..V-1 and slots V+1..2V-1.
struct ClassicSums {
    long long c0, cv, sp, sm;
    uint32_t p0, pv, pp, pm;
};

// The hit of one anchor as _hits writes it.
struct Hit {
    bool aligned;
    uint32_t pos;
    int strand, mm, n_best, second_mm, qual;
};

__device__ __forceinline__ ClassicSums classic_none() {
    return {0, 0, 0, 0, kLargePos, kLargePos, kLargePos, kLargePos};
}

// Loads of another shard's record issued where they are written: an asm
// volatile statement is not moved, where the compiler sinks a plain load
// to its first use (behind the key build and the row round trip that
// come between them).
__device__ __forceinline__ int32_t load_now(const int32_t* p) {
    int32_t v;
    asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

__device__ __forceinline__ int4 load_now(const int4* p) {
    int4 v;
    asm volatile("ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
}

// s with record r (kClassicFields int32) folded in.
__device__ __forceinline__ void fold(ClassicSums& s, const int32_t* r) {
    s.c0 += r[0];
    s.cv += r[1];
    s.sp += r[2];
    s.sm += r[3];
    s.p0 = min(s.p0, (uint32_t)r[4]);
    s.pv = min(s.pv, (uint32_t)r[5]);
    s.pp = min(s.pp, (uint32_t)r[6]);
    s.pm = min(s.pm, (uint32_t)r[7]);
}

// finalize_hits on combined classic records, with _hits' frozen best-hit
// selection and MAPQ surrogate (SPEC §2): mm is 0 only at the exact
// slots 0 (the '+' strand) and V (the '-' strand); `al` the anchor
// length.
__device__ __forceinline__ Hit classic_finish(const ClassicSums& s,
                                              int max_anchor_mm, int al) {
    const long long n_exact = s.c0 + s.cv, total = s.sp + s.sm;
    const bool any_exact = n_exact > 0, any_at_all = total > 0;
    const int m0 = any_exact ? 0 : (any_at_all ? 1 : kLargeMm);
    const long long n_best = any_exact ? n_exact : total;
    const bool has_p = any_exact ? s.c0 > 0 : s.sp > 0;
    const int strand = has_p ? 0 : (any_at_all ? 1 : 2);
    const uint32_t pos = m0 == 0   ? (strand == 0   ? s.p0
                                      : strand == 1 ? s.pv
                                                    : kLargePos)
                         : m0 == 1 ? (strand == 0   ? s.pp
                                      : strand == 1 ? s.pm
                                                    : kLargePos)
                                   : kLargePos;
    const int second_mm = n_best > 1 ? m0
                          : (m0 == 0 && total > n_exact) ? 1
                                                         : al + 1;
    const int q10 = 10 * (second_mm - m0);
    return {m0 <= max_anchor_mm, pos, strand, m0, (int)n_best, second_mm,
            n_best > 1 ? 0 : (q10 < 40 ? q10 : 40)};
}

}  // namespace fc2t
