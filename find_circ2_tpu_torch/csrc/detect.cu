// Detect's per-read core (K-e + K-f) of one batch: a group of kGroup
// lanes per read, one launch per batch.
//
// Replaces, after K1, everything of the plain detect_core_packed_ref in
// find_circ2_tpu_torch/ops/detect.py: _full_read_mm (the §6 prefilter
// at both anchor placements), detect_core (pairing, strand
// canonicalization, chromosomes, the frozen status priority, multi),
// ops/breakpoint.breakpoint_search (K2: two (Lp+2)-wide windows, prefix
// mismatch sums, the score of every split and the frozen tie-break),
// ops/packed.gather_window (K-a) under all of them, and _pack. The
// reference computes the same as XLA programs, not Pallas
// (find_circ2_tpu/models/pipeline.py:126 _full_read_mm, :427 detect_core,
// the packing at :251-258; find_circ2_tpu/ops/breakpoint.py:40, whose
// prefix sums are a bf16 triangular-ones matmul; ops/packed.py:49). The
// plain version is about 340 eager kernels a batch over [B, Lp+2] int32
// windows and [B, Lp+1] split grids.
//
// What bounds it on this card. A 4096-read batch moves about 3 MB (the
// reads and their reverse complements, the hit fields, four windows of
// its length a read, the [B, 14] rows): under a microsecond at 3.35
// TB/s. Its arithmetic, about a dozen 32-bit operations for each valid
// split, is less. chip_smoke.py computes both from each run's shapes.
// What a read waits for is latency: its hit fields, then the genome
// windows at its anchors' positions, two dependent round trips that no
// design removes. The windows are data-dependent gathers of a few dozen
// bytes, so neither tensor cores nor TMA apply; what the design does:
//
//  - Two round trips a read, no more. The first issues every load that
//    needs no position: the length, all ten hit fields, the overflow
//    flag, and the first round's read and reverse-complement bases as
//    4-byte words (any row alignment). The second issues the four
//    windows' nibble words (csrc/nibbles.cuh's format) and, with them,
//    both anchors' chromosome lookups, a kGroup-way search by ballot.
//  - kReadsPerWarp reads a warp: lane g of a read's group takes splits
//    8g .. 8g+7 of each round, and a read takes as many rounds as its
//    length needs (one up to 8 kGroup bases), so lanes do not idle on
//    padding up to Lp. Two reads a warp beat one (a warp's lanes past a
//    100-base read idled) and four (two rounds a read), and blocks of
//    128 threads beat 256 and 512: the split scan is a warp's chain of
//    dependent arithmetic, and it stretches with each warp that shares
//    its scheduler. A scan over the group of the lanes' mismatch counts
//    gives each lane its prefix; the split grid never exists.
//  - The score at split k is prefA(k) + totB - prefB(k); totB is one
//    constant of the read, so the lanes minimize the packed key with
//    d(k) = prefA(k) - prefB(k) in its place (same order, same first
//    minimum) and add totB to the minimum at the end. Each lane keeps
//    its best split's four signal bases and k beside its key, so the
//    group's minimum brings them along. A lane's eight splits are
//    scored at once, as the nibbles and bytes of words (a product
//    spreads the prefix sums, byte minima pick the least), and a round's
//    four mismatch counts are scanned over the group as the bytes of
//    one word. Nothing divides: the best split's k travels with its
//    key, and the least d comes from the count's reduction.
//  - The prefilter's two Hamming counts use the same lanes and words.
//  - The finish runs on every lane of the group, and the 56-byte row is
//    written a field a lane.

// Plain C interface for ctypes: one packed argument buffer (DetectArgs).
// The entry returns the kernels it launched (1, or 0 for an empty batch),
// or minus a CUDA error.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "nibbles.cuh"

// One anchor's finalize_hits / exact_anchor_stats fields, [B] each.
struct DetectAnchor {
    const int64_t* pos;      // uint32 values
    const int32_t* strand;   // 0, 1 or 2
    const uint8_t* aligned;  // bool
    const int32_t* n_best;
    const int32_t* qual;
};

// The arguments of one call, packed by ops/detect.py into one buffer.
struct DetectArgs {
    const int32_t* words;          // nibble-packed genome (ops/packed.py)
    const int64_t* chrom_offsets;  // [n_chroms], ascending
    const uint8_t* reads;          // [B, Lp] codes
    const uint8_t* rc;             // [B, Lp] reverse complements
    const int32_t* lens;           // [B]
    int32_t* out;                  // [B, 14], PACK_FIELDS order
    const uint8_t* overflow;       // 0-d bool: multi bit 3, or null
    DetectAnchor anchor[2];        // anchors A and B
    void* stream;
    long long nbases;              // >= Lp + 2
    int B, Lp, n_chroms, anchor_len, prefilter_mm, prefilter, device,
        reserved;
};
static_assert(sizeof(DetectArgs) == 184, "layout packed by ops/detect");

// Built with FC2T_DETECT_STAMPS (ops/detect.detect_stage_cycles), lane 0
// of each warp records its SM clock at the start and after each stage,
// kDetectStamps values a warp into fc2t_dstamps[warps, kDetectStamps]. A
// stage ends where its results are first used. Without it, DSTAMP is
// nothing.
#ifdef FC2T_DETECT_STAMPS
constexpr int kDetectStamps = 6;
__device__ unsigned long long* fc2t_dstamps = nullptr;
// Stamp `at` of the buffer: `dep` is stored first, so the clock is read
// only once the values it is made from have arrived.
__device__ __forceinline__ void detect_stamp(size_t at, unsigned dep) {
    volatile unsigned long long* p = fc2t_dstamps;
    if (!p) return;
    p[at] = dep;
    p[at] = clock64();
}
#define DSTAMP(at, dep) detect_stamp((at), (unsigned)(dep))
#else
#define DSTAMP(at, dep) \
    do {                \
    } while (0)
#endif

namespace {

using fc2t::comp;
using fc2t::mismatches;
using fc2t::same;

constexpr int kThreads = 128;
constexpr int kReadsPerWarp = 2;
constexpr int kGroup = 32 / kReadsPerWarp;        // lanes a read
constexpr int kReadsPerBlock = kThreads / kGroup;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kGroupBits =
    kGroup == 32 ? kFull : (1u << (kGroup & 31)) - 1u;
constexpr int kBig = 1 << 20;             // ops/breakpoint.py BIG
constexpr int kNoSplit = 0x7fffffff;      // no valid split
constexpr int kPackFields = 14;
// config.py's codes.
constexpr int kA = 0, kC = 1, kG = 2, kT = 3, kRpad = 6;
constexpr int kJunction = 0, kPrefiltered = 3, kUnalignedA = 4,
              kUnalignedB = 5, kDiffStrand = 6, kDiffChrom = 7,
              kAnchorOverlap = 8, kNoJunction = 9;
constexpr int kLinear = 0, kCircular = 1, kSensePlus = 0, kSenseMinus = 1;

// Bases p .. p+7 (p < Lp) of a [Lp] row of codes as nibbles, base p
// lowest, from the aligned 4-byte words that hold them: two, or three
// when the row is not on 4 bytes. A word that starts past the row is not
// read and gives RPAD; bytes past the row's end in a word that is read
// are the next row's. Neither is ever compared: the callers mask every
// base at or past the read's length.
__device__ __forceinline__ uint32_t row_nibbles(const uint8_t* row, int p,
                                                int Lp) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(row + p);
    const uintptr_t end = reinterpret_cast<uintptr_t>(row + Lp);
    const auto* w = reinterpret_cast<const uint32_t*>(at & ~uintptr_t(3));
    const int sh = (int)(at & 3);
    constexpr uint32_t kPad = kRpad * 0x01010101u;
    const uint32_t x0 = __ldg(w);
    const uint32_t x1 = reinterpret_cast<uintptr_t>(w + 1) < end
                            ? __ldg(w + 1) : kPad;
    const uint32_t x2 = sh && reinterpret_cast<uintptr_t>(w + 2) < end
                            ? __ldg(w + 2) : kPad;
    const uint32_t lo = __funnelshift_r(x0, x1, 8 * sh);
    const uint32_t hi = __funnelshift_r(x1, x2, 8 * sh);
    // Codes < 16: byte 0 of y is code 0 | code 1 << 4, byte 2 code 2 |
    // code 3 << 4.
    return __byte_perm(lo | lo >> 4, hi | hi >> 4, 0x6420);
}

// A lane's nibble words of one genome window that starts at base s: the
// words from s / 8 + m on, the third only when an offset c <= cmax needs
// it (win_nib). They cover window bases 8m + c .. 8m + c + 7.
struct Win {
    uint32_t x0 = 0, x1 = 0, x2 = 0, o = 0;
};

__device__ __forceinline__ Win load_win(const uint32_t* words, uint32_t s,
                                        int m, int cmax) {
    const uint32_t* w = words + (s >> 3) + m;
    Win v;
    v.o = s & 7u;
    v.x0 = __ldg(w);
    v.x1 = __ldg(w + 1);
    if ((int)v.o + cmax >= 8) v.x2 = __ldg(w + 2);
    return v;
}

// Window bases 8m + c .. 8m + c + 7 as nibbles, base 8m + c lowest
// (nibbles.cuh's nibbles at t = 8m + c).
__device__ __forceinline__ uint32_t win_nib(const Win& v, int c) {
    const uint32_t t = v.o + (uint32_t)c;
    return __funnelshift_r(t < 8 ? v.x0 : v.x1, t < 8 ? v.x1 : v.x2,
                           4 * (t & 7u)) &
           0x77777777u;
}

// Bases j of four nibble words (donor GA[k], GA[k+1], acceptor GB[k],
// GB[k+1]) as the packed signal d0 | d1 << 3 | a0 << 6 | a1 << 9.
__device__ __forceinline__ uint32_t sig_at(uint32_t d0, uint32_t d1,
                                           uint32_t a0, uint32_t a1, int j) {
    const int s = 4 * j;
    return (d0 >> s & 7u) | (d1 >> s & 7u) << 3 | (a0 >> s & 7u) << 6 |
           (a1 >> s & 7u) << 9;
}

// Nibbles 0..3 of x as the bytes 0..3 of a word.
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t x) {
    x = (x & 0xffffu) | (x & 0xffffu) << 8;
    x &= 0x00ff00ffu;
    return (x | x << 4) & 0x0f0f0f0fu;
}

// The minimum over a read's group of lanes.
template <typename T>
__device__ __forceinline__ T group_min(T x) {
#pragma unroll
    for (int d = kGroup / 2; d >= 1; d >>= 1) {
        const T y = __shfl_xor_sync(kFull, x, d, kGroup);
        x = y < x ? y : x;
    }
    return x;
}

// The least (d + Lp) << 16 | count over a read's group: the least d, and
// the counts of the lanes at it summed. kNoLeast: no valid split.
constexpr int kNoLeast = 0x7fff0000;

__device__ __forceinline__ int group_least_count(int x) {
#pragma unroll
    for (int d = kGroup / 2; d >= 1; d >>= 1) {
        const int y = __shfl_xor_sync(kFull, x, d, kGroup);
        const int lx = x >> 16, ly = y >> 16;
        x = lx < ly ? x : ly < lx ? y : x + (y & 0xffff);
    }
    return x;
}

// searchsorted(off, x, right=True), the offsets <= x, for x = xa and xb
// of each read's group at once: each round the group's lanes compare
// kGroup evenly spaced offsets of the open range and a ballot narrows it
// kGroup-fold, so up to kGroup chromosomes take one round trip. Called by
// the whole warp; groups that are done idle.
__device__ __forceinline__ void upper2(const int64_t* off, int n,
                                       long long xa, long long xb, int gl,
                                       int gbase, int& ca, int& cb) {
    int lo[2] = {0, 0}, hi[2] = {n, n};
    const long long x[2] = {xa, xb};
    while (__any_sync(kFull, lo[0] < hi[0] || lo[1] < hi[1])) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
            const int stride = (hi[t] - lo[t] + kGroup - 1) / kGroup;
            const int j = lo[t] + gl * stride;
            const bool le = lo[t] < hi[t] && j < hi[t] && off[j] <= x[t];
            // The offsets ascend, so the lanes that hold are a prefix.
            const int held =
                __popc(__ballot_sync(kFull, le) >> gbase & kGroupBits);
            if (lo[t] < hi[t]) {
                if (held == 0) {
                    hi[t] = lo[t];
                } else {
                    const int last = lo[t] + (held - 1) * stride;
                    hi[t] = min(hi[t], last + stride);
                    lo[t] = last + 1;
                }
            }
        }
    }
    ca = lo[0];
    cb = lo[1];
}

__global__ void __launch_bounds__(kThreads)
detect_kernel(const __grid_constant__ DetectArgs a) {
    const int lane = threadIdx.x & 31;
    const int gl = lane & (kGroup - 1);   // lane within the read's group
    const int gbase = lane & ~(kGroup - 1);
    const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
    if (warp * kReadsPerWarp >= a.B) return;  // whole warps leave together
    // A group past the batch's end computes the last read again and
    // writes nothing: every lane of the warp takes part in the shuffles.
    const int b_raw = warp * kReadsPerWarp + lane / kGroup;
    const bool real = b_raw < a.B;
    const int b = real ? b_raw : a.B - 1;
#ifdef FC2T_DETECT_STAMPS
    const size_t at = (size_t)warp * kDetectStamps;
    if (lane == 0) DSTAMP(at, 0);
#endif
    const int Lp = a.Lp, al = a.anchor_len;
    const uint32_t ua = (uint32_t)al;
    const uint8_t* read = a.reads + (size_t)b * Lp;
    const uint8_t* rcrow = a.rc + (size_t)b * Lp;
    const DetectAnchor& A = a.anchor[0];
    const DetectAnchor& Bn = a.anchor[1];
    const auto* words = reinterpret_cast<const uint32_t*>(a.words);

    // The first round trip: everything that does not depend on a
    // position, the first round's read and reverse-complement bases
    // included.
    const int len = a.lens[b];
    const long long pos_a = A.pos[b], pos_b = Bn.pos[b];
    const int str_a = A.strand[b], str_b = Bn.strand[b];
    const bool al_a = A.aligned[b] != 0, al_b = Bn.aligned[b] != 0;
    const int nb_a = A.n_best[b], nb_b = Bn.n_best[b];
    const int qual_a = A.qual[b], qual_b = Bn.qual[b];
    const int overflow = a.overflow ? (a.overflow[0] != 0) : 0;
    uint32_t qf = 0, qr = 0;
    if (8 * gl < Lp) {
        qf = row_nibbles(read, 8 * gl, Lp);
        qr = row_nibbles(rcrow, 8 * gl, Lp);
    }
#ifdef FC2T_DETECT_STAMPS
    {
        const unsigned dep = __reduce_xor_sync(
            kFull, (unsigned)(len ^ pos_a ^ pos_b ^ str_a ^ str_b ^ al_a ^
                              al_b ^ nb_a ^ nb_b ^ qual_a ^ qual_b ^
                              overflow) ^ qf ^ qr);
        if (lane == 0) DSTAMP(at + 1, dep);
    }
#endif
    const uint32_t ua_pos = (uint32_t)pos_a, ub_pos = (uint32_t)pos_b;

    // Pairing + canonicalization (SPEC.md §3): '-' reads swap the anchors
    // and read the reverse complement.
    const int s = str_a;
    const bool minus = s == 1;
    const uint32_t pA = minus ? ub_pos : ua_pos;
    const uint32_t pB = minus ? ua_pos : ub_pos;
    const uint32_t endB = pB + ua;
    const bool linear = pA + ua <= pB;
    const bool circular = endB <= pA;

    // Window starts: the prefilter's Lp-wide windows of both anchors and
    // K2's (Lp+2)-wide windows GA (left piece and donor) and GB (acceptor
    // and right piece), each clamped as the plain code clamps its masked
    // uint32 start.
    const uint32_t top_p = (uint32_t)(a.nbases - Lp);
    const uint32_t top_k = (uint32_t)(a.nbases - (Lp + 2));
    const bool fwd_a = str_a == 0, fwd_b = str_b == 0;
    uint32_t pf_a = fwd_a ? ua_pos : ua_pos + ua - (uint32_t)len;
    uint32_t pf_b = fwd_b ? ub_pos + ua - (uint32_t)len : ub_pos;
    pf_a = pf_a < top_p ? pf_a : top_p;
    pf_b = pf_b < top_p ? pf_b : top_p;
    const uint32_t sA = pA < top_k ? pA : top_k;
    uint32_t sB = endB - (uint32_t)len - 2u;
    sB = sB < top_k ? sB : top_k;

    // Round r gives lane gl splits k = 8m .. 8m+7, m = r kGroup + gl, and
    // read bases 8m .. 8m+7: the bases compared are [0, lim), the valid
    // splits [al, kmax]. Group lane 0 of round 0 reads its K2 windows
    // whatever the length: the signal of a read without a valid split is
    // that of split 0.
    const int lim = len < Lp ? len : Lp;
    const int kmax = len - al < Lp ? len - al : Lp;
    const int span = lim > kmax + 1 ? lim : kmax + 1;  // k0 < span matter
    const int rounds = __reduce_max_sync(
        kFull, span > 8 * kGroup ? (span + 8 * kGroup - 1) / (8 * kGroup) : 1);
    Win ga, gb, wpa, wpb;
    if (8 * gl < span || gl == 0) {
        ga = load_win(words, sA, gl, 1);
        gb = load_win(words, sB, gl, 2);
    }
    if (8 * gl < lim && a.prefilter) {
        wpa = load_win(words, pf_a, gl, 0);
        wpb = load_win(words, pf_b, gl, 0);
    }
    // Both anchors' chromosomes while the windows fly.
    int chrom_a, chrom_b;
    upper2(a.chrom_offsets, a.n_chroms, pos_a, pos_b, gl, gbase, chrom_a,
           chrom_b);
    --chrom_a;
    --chrom_b;
#ifdef FC2T_DETECT_STAMPS
    {
        const unsigned dep = __reduce_xor_sync(
            kFull, ga.x0 ^ ga.x1 ^ ga.x2 ^ gb.x0 ^ gb.x1 ^ gb.x2 ^ wpa.x0 ^
                       wpa.x1 ^ wpb.x0 ^ wpb.x1 ^ chrom_a ^ chrom_b);
        if (lane == 0) DSTAMP(at + 2, dep);
    }
#endif

    // Each round: the lane's mismatch counts against GA, GB and both
    // prefilter windows, a byte each of one word, scanned over the group
    // (a round's counts are at most 8 kGroup < 256): prefA(k) and
    // prefB(k) at the lane's first split, and the totals.
    static_assert(8 * kGroup < 256, "a round's counts fit in a byte");
    int carryA = 0, carryB = 0, mm_a = 0, mm_b = 0;
    int best_key = kNoSplit, best_d = kNoSplit, n_at = 0;
    uint32_t best_sig = 0, sig0 = 0;
    for (int r = 0; r < rounds; ++r) {
        const int m = r * kGroup + gl;
        const int k0 = 8 * m;
        if (r > 0) {
            qf = qr = 0;
            if (k0 < lim) {
                qf = row_nibbles(read, k0, Lp);
                qr = row_nibbles(rcrow, k0, Lp);
            }
            if (k0 < span) {
                ga = load_win(words, sA, m, 1);
                gb = load_win(words, sB, m, 2);
            }
            if (k0 < lim && a.prefilter) {
                wpa = load_win(words, pf_a, m, 0);
                wpb = load_win(words, pf_b, m, 0);
            }
        }
        uint32_t misA = 0, misB = 0, misPa = 0, misPb = 0;
        if (k0 < lim) {
            const uint32_t q = minus ? qr : qf;
            misA = mismatches(q, win_nib(ga, 0), lim - k0);
            misB = mismatches(q, win_nib(gb, 2), lim - k0);
            if (a.prefilter) {
                misPa = mismatches(fwd_a ? qf : qr, win_nib(wpa, 0), lim - k0);
                misPb = mismatches(fwd_b ? qf : qr, win_nib(wpb, 0), lim - k0);
            }
        }
        const uint32_t own = __popc(misA) | __popc(misB) << 8 |
                             __popc(misPa) << 16 | __popc(misPb) << 24;
        uint32_t inc = own;  // inclusive scan over the group
#pragma unroll
        for (int d = 1; d < kGroup; d <<= 1) {
            const uint32_t y = __shfl_up_sync(kFull, inc, d, kGroup);
            if (gl >= d) inc += y;
        }
        const uint32_t pre = inc - own;
        const uint32_t tot = __shfl_sync(kFull, inc, kGroup - 1, kGroup);
        const int preA = carryA + (int)(pre & 0xffu);
        const int preB = carryB + (int)(pre >> 8 & 0xffu);
        carryA += (int)(tot & 0xffu);
        carryB += (int)(tot >> 8 & 0xffu);
        mm_a += (int)(tot >> 16 & 0xffu);
        mm_b += (int)(tot >> 24);
        if (m == 0)
            sig0 = sig_at(win_nib(ga, 0), win_nib(ga, 1), win_nib(gb, 0),
                          win_nib(gb, 1), 0);
        // The lane's valid splits k0 + j, j in [jlo, jhi].
        const int jlo = al - k0 > 0 ? al - k0 : 0;
        const int jhi = kmax - k0 < 7 ? kmax - k0 : 7;
        if (jlo > jhi) continue;
        // Canonical dinucleotides of every split of the lane (donor
        // GA[k], GA[k+1]; acceptor GB[k], GB[k+1]) as the tie-break's
        // !canon+ (4) + !canon- (2) in each split's nibble.
        const uint32_t d0 = win_nib(ga, 0), d1 = win_nib(ga, 1);
        const uint32_t a0 = win_nib(gb, 0), a1 = win_nib(gb, 1);
        const uint32_t cp = same(d0, kG) & same(d1, kT) & same(a0, kA) &
                            same(a1, kG);
        const uint32_t cm = same(d0, kC) & same(d1, kT) & same(a0, kA) &
                            same(a1, kC);
        const uint32_t flags =
            (~cp & 0x11111111u) * 4u + (~cm & 0x11111111u) * 2u;
        // All eight splits at once, a nibble each: the mismatches before
        // base j of the lane (a product spreads the prefix sums, at most
        // 7 a nibble), and e = 8 + those of GA - those of GB, in [1, 15]:
        // d(k0 + j) = preA - preB + e_j - 8.
        const uint32_t e =
            misA * 0x11111110u + 0x88888888u - misB * 0x11111110u;
        const uint32_t valid = (kFull >> (4 * (7 - jhi))) >> (4 * jlo)
                                                          << (4 * jlo);
        // The frozen tie-break (score, !canon+, !canon-, k) within the
        // lane: the least byte e_j << 3 | flag_j over the valid splits
        // (bytes j of `lo`, j - 4 of `hi`; 0xff past them), its first j.
        const uint32_t vlo = nibble_bytes(valid) * 0x11u;
        const uint32_t vhi = nibble_bytes(valid >> 16) * 0x11u;
        const uint32_t lo =
            (nibble_bytes(e) << 3 | nibble_bytes(flags)) | ~vlo;
        const uint32_t hi =
            (nibble_bytes(e >> 16) << 3 | nibble_bytes(flags >> 16)) | ~vhi;
        uint32_t least = __vminu4(lo, hi);
        least = __vminu4(least, least >> 16);
        least = __vminu4(least, least >> 8) & 0xffu;
        const uint32_t eq_lo = __vcmpeq4(lo, least * 0x01010101u);
        const uint32_t eq_hi = __vcmpeq4(hi, least * 0x01010101u);
        const int j = eq_lo ? (__ffs(eq_lo) - 1) >> 3
                            : 4 + ((__ffs(eq_hi) - 1) >> 3);
        const int key = ((preA - preB + Lp - 8) * 8 + (int)least) *
                            (Lp + 2) + k0 + j;
        if (key < best_key) {
            best_key = key;
            best_sig = sig_at(d0, d1, a0, a1, j) | (uint32_t)(k0 + j) << 12;
        }
        // The lane's least d and its valid splits at it.
        const uint32_t e_min = least >> 3;
        const uint32_t z = e ^ (e_min * 0x11111111u);
        const int at_min =
            __popc(~(z | z >> 1 | z >> 2 | z >> 3) & valid & 0x11111111u);
        const int d_lane = preA - preB + (int)e_min - 8;
        n_at = d_lane < best_d    ? at_min
               : d_lane == best_d ? n_at + at_min
                                  : n_at;
        best_d = min(best_d, d_lane);
    }
    // The group's least key with its split's signal and k (d(k) is the
    // key's leading part), and, independently, its least d with the
    // number of splits at it, (d + Lp) << 16 | count.
    const unsigned long long kb = group_min(
        (unsigned long long)(unsigned)best_key << 32 | best_sig);
    const int dc = group_least_count(
        best_d == kNoSplit ? kNoLeast : (best_d + Lp) << 16 | n_at);
    const bool any_split = (int)(kb >> 32) != kNoSplit;
    const int n_bp = any_split ? dc & 0xffff : 0;
    const int totB = carryB;
    const uint32_t sig_raw = any_split ? (uint32_t)kb & 0xfffu
                                       : __shfl_sync(kFull, sig0, 0, kGroup);
#ifdef FC2T_DETECT_STAMPS
    if (lane == 0)
        DSTAMP(at + 3, (int)kb ^ n_bp ^ mm_a ^ mm_b ^ totB ^ sig_raw);
#endif

    // The finish, by every lane of the group: the best split's junction,
    // dinucleotides and sense.
    const int best_k = any_split ? (int)((uint32_t)kb >> 12) : 0;
    const int edits = any_split ? (dc >> 16) - Lp + totB : kBig;
    const uint32_t uk = (uint32_t)best_k;
    const uint32_t donor = pA + uk;
    const uint32_t acceptor = endB + uk - (uint32_t)len;
    const uint32_t start = circular ? acceptor : donor;
    const uint32_t end = circular ? donor : acceptor;
    const int d0 = sig_raw & 7, d1 = sig_raw >> 3 & 7, a0 = sig_raw >> 6 & 7,
              a1 = sig_raw >> 9 & 7;
    const bool canon_p = d0 == kG && d1 == kT && a0 == kA && a1 == kG;
    const bool canon_m = d0 == kC && d1 == kT && a0 == kA && a1 == kC;
    const int sense = canon_p ? kSensePlus : canon_m ? kSenseMinus : s;
    const int sig = sense == kSenseMinus
                        ? comp(a1) | comp(a0) << 3 | comp(d1) << 6 |
                              comp(d0) << 9
                        : (int)sig_raw;
    // Anchor overlap at the best split: max(0, min_e - max_s).
    const uint32_t e_a = pA + uk, s_b = endB + uk - (uint32_t)len;
    const uint32_t min_e = e_a < endB ? e_a : endB;
    const uint32_t max_s = pA > s_b ? pA : s_b;
    const uint32_t overlap = min_e > max_s ? min_e - max_s : 0u;

    // Status [FROZEN priority]: prefiltered > unaligned_A > unaligned_B >
    // diff_strand > diff_chrom > anchors_overlap > no_junction >
    // junction.
    const bool contig = a.prefilter && ((al_a && mm_a <= a.prefilter_mm) ||
                                        (al_b && mm_b <= a.prefilter_mm));
    int status = kJunction;
    if (!circular && end <= start) status = kNoJunction;  // linear only
    if (!(linear || circular)) status = kAnchorOverlap;
    if (chrom_a != chrom_b) status = kDiffChrom;
    if (str_a != str_b) status = kDiffStrand;
    if (!al_b) status = kUnalignedB;
    if (!al_a) status = kUnalignedA;
    if (contig) status = kPrefiltered;
    const int multi = (nb_a > 1 || nb_b > 1 ? 1 : 0) |
                      (al_a != al_b ? 2 : 0) | overflow << 3;
    const int field[kPackFields] = {
        status, circular ? kCircular : kLinear, chrom_a, (int)start,
        (int)end, sense, s, edits, n_bp, (int)overlap,
        minus ? qual_b : qual_a, minus ? qual_a : qual_b, multi, sig};
#ifdef FC2T_DETECT_STAMPS
    if (lane == 0)
        DSTAMP(at + 4, status ^ chrom_a ^ multi ^ sig ^ (int)overlap ^
                           field[10]);
#endif

    // The 56-byte row, a field a lane.
    int32_t* o = a.out + (size_t)b * kPackFields;
#pragma unroll
    for (int f0 = 0; f0 < kPackFields; f0 += kGroup) {
        const int f = f0 + gl;
        int v = field[0];
#pragma unroll
        for (int t = 1; t < kPackFields; ++t) v = f == t ? field[t] : v;
        if (real && f < kPackFields) o[f] = v;
    }
#ifdef FC2T_DETECT_STAMPS
    if (lane == 0) DSTAMP(at + 5, 0);
#endif
}

}  // namespace

// Host side: the C entry.

// out[b] = the packed detect row of read b, for every read of the batch.
extern "C" int fc2t_detect(const DetectArgs* a) {
    if (a->B <= 0) return 0;
    // Packed split keys ((2 Lp) * 8 + 6) * (Lp + 2) + Lp stay below 2^31.
    if (a->rc == nullptr || a->Lp < 1 || a->Lp > 4096 || a->n_chroms < 1 ||
        a->nbases < a->Lp + 2)
        return -(int)cudaErrorInvalidValue;
    int dev = -1;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -(int)err;
    if (dev != a->device) return -(int)cudaErrorInvalidDevice;
    const unsigned blocks =
        (unsigned)((a->B + kReadsPerBlock - 1) / kReadsPerBlock);
    detect_kernel<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(a->stream)>>>(*a);
    err = cudaGetLastError();
    return err == cudaSuccess ? 1 : -(int)err;
}

#ifdef FC2T_DETECT_STAMPS
// Where the next launches record their stage clocks (null: nowhere).
extern "C" int fc2t_detect_stamps(void* stamps) {
    unsigned long long* p = static_cast<unsigned long long*>(stamps);
    const cudaError_t err = cudaMemcpyToSymbol(fc2t_dstamps, &p, sizeof p);
    return err == cudaSuccess ? 0 : -(int)err;
}
#endif
