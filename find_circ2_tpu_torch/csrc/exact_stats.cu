// K1 v4's exact-first probe (K-b) of a batch's stacked anchors: four
// lanes per anchor, one launch per batch.
//
// Replaces, on one index table, everything of the plain
// exact_anchor_stats_ref in find_circ2_tpu_torch/ops/anchor_align.py:
// _exact_keys (the canonical (p12, s8) key of each anchor and whether its
// reverse complement is smaller), index/hashtable.mix_hash for both salts,
// _bucket_rows (the table's and the neighbour table's rows at both cuckoo
// probes, a gather_rows_multi launch there), exact_partials and
// exact_finish (the frozen SPEC §2 statistics and `resolved`). The
// reference computes the same as one XLA program, not Pallas
// (find_circ2_tpu/ops/anchor_align.py:340 exact_anchor_stats). The plain
// version is about 300 eager kernels a 4096-read batch.
//
// What bounds it on this card. Each anchor reads its 20 codes and four
// 32-byte rows, and writes about 30 bytes: about 1.5 MB a batch of 8192
// anchors, half a microsecond at 3.35 TB/s; its arithmetic (two hashes,
// eight slot compares) is less. But each row is one random access into a
// table larger than the L2, and random 32-byte rows move at about a third
// of the bytes rate (chip_smoke.py measures that rate with gather_rows
// and prints the probe's floor beside its bound). So the design puts as
// many rows in flight on as many SMs as it can:
//
//  - Four lanes an anchor, one row each (a probe's table row or its
//    neighbour-table row, two 16-byte loads): 8192 anchors are 256
//    blocks of 128 threads, every SM busy, where one thread an anchor
//    filled half of them with 64 blocks.
//  - The key without a per-byte dependent loop: an anchor row on 4 bytes
//    (anchor_len a multiple of 4) is read as words, all in flight, and
//    its digits packed by word operations; the reverse complement's key
//    is the digits complemented and reversed (a bit reversal). Any other
//    row is read a byte at a time.
//  - The table lane's slot matches go to its neighbour-table lane by one
//    shuffle; the four lanes' partials combine by two butterfly steps;
//    each lane then finishes and writes a quarter of the outputs, so each
//    store writes eight neighbouring anchors.
//
// No shared memory, no tensor cores, no TMA: nothing is shared between
// anchors, and the loads are data-dependent 32-byte rows.
//
// On an index shard of the sharded engine (parallel/sharded.py) the same
// kernel runs in partials mode: each anchor's nine partials of
// exact_partials, the shard's part of the reference's exact_anchor_stats
// with axis_name (find_circ2_tpu/ops/anchor_align.py:340, its psum/pmin at
// :424-438), go to a record row. One shard of the data row, the first on
// the anchors' device, launched after the others, runs in combining mode
// instead: it reads the other shards' records of its anchors, folds them
// into its own partials, which stay in registers and are never written,
// and runs the single table's finish on the sums. The cross-shard finish
// now sits in this epilogue, and the sharded engine launches no kernel of
// its own for it. What bounds it is the other shards' records, read once
// (36 bytes a shard an anchor), and about 100 integer operations an
// anchor, far under the kernel's own row round trip. So the records'
// loads are issued first, beside the code loads and before the hash and
// the row loads, and their round trip overlaps the key build and the row
// round trip; the first kHeldShards records of an anchor wait in
// registers, any further ones are loaded at the fold. Every lane of an
// anchor loads all its fields (one address a field for the anchor's four
// lanes) and folds them after the lanes' own partials are combined, in
// 64 bits after the packed counts are unpacked: a packed count holds at
// most 1023, one shard's and not the sum of 64. Splitting the fields
// over the four lanes, folded before the lanes combine, was slower
// (PERF.md §6). A launch of its
// own would cost each phase of a data row its fixed start once more than
// it needs. Thread-block clusters and distributed shared memory would
// only help when all of a row's shards lie on one card, which is the
// test layout and not a deployment, and programmatic dependent launch
// overlaps a launch but keeps it.
//
// A shard holds only the keys whose canonical p12 lies in its range
// [lo, hi) (ops/anchor_align.key_ranges), so the partials mode looks up
// only those: an anchor whose key lies outside issues no hash and no row
// load, and its record is that of a key the shard lacks (found 0, counts
// 0, positions LARGE_POS). Before, a data row of S shards fetched S
// times the rows of one table, S - 1 of every S known to be empty. The
// key is built before the hash, so the test costs nothing before the
// round trip. The owned anchors are not packed into fewer warps (a
// ballot and popc would do it): the grid is under one wave, so the
// kernel takes as long as its slowest warp's chain, code load, key,
// row round trip, fold and write, and packing cannot shorten that chain;
// it would only leave warps idle. What ownership buys is rows: at 2
// shards every warp that owns none of its 8 anchors skips the round
// trip, and the rows in flight on the card fall to the shard's share.
// The stage clocks of both modes, every key and the shard's range, are
// in PERF.md (exact_stage_cycles with `records`). The range test is
// compiled into the partials and combining modes only (kRanged), the
// fold into the combining mode only (kCombine): the finish on one table
// is the kernel it was.
//
// Kept bit for bit: when a key's two buckets are one bucket both probes
// match its slot and their counts add (ROADMAP.md §3); a dirty anchor
// (a code >= 4) is looked up on its codes with those zeroed, is not
// clean, and resolves; exact counts above max_bucket count as 0; a
// bucket at or past the table's rows reads empty.
//
// Plain C interface for ctypes: one packed argument buffer (ExactArgs).
// The entry returns the kernels it launched (1, or 0 for no anchors), or
// minus a CUDA error.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "cuckoo.cuh"
#include "shard_finish.cuh"

// The arguments of one call, packed by ops/anchor_align.py into one
// buffer.
// Three modes: the finish (partials == nullptr) writes the hits and
// `resolved`; the partials mode (an index shard's part, partials !=
// nullptr, the hit pointers null) writes each anchor's kExactFields
// record and stops before the finish: no guard and no `clean`, which
// belong to the finish over every shard; the combining mode (the finish
// with n_others >= 1, or with a range other than every key) looks up
// the keys of [lo, hi), folds in the other shards' records `others` and
// finishes. The finish of every key and no others is the single table's.
// The combining mode's fields come last, so the others keep their
// offsets.
struct ExactArgs {
    const uint8_t* anchors;   // [n, anchor_len] codes
    const int32_t* table;     // [rows, SLOTS * LANES] cuckoo table
    const int32_t* ntable;    // [rows, SLOTS * NBR_LANES] neighbour table
    const int32_t* meta;      // (salt0, salt1, n_buckets, ...), uint32 bits
    uint8_t* aligned;         // [n] bool; the AnchorHits fields, then
    int64_t* pos;             // [n], uint32 values
    int32_t* strand;          // [n]
    int32_t* mm;              // [n]
    int32_t* n_best;          // [n]
    int32_t* second_mm;       // [n]
    int32_t* qual;            // [n]
    uint8_t* resolved;        // [n] bool
    int32_t* partials;        // [n, kExactFields], or null
    void* stream;
    long long rows;           // table rows; a bucket at or past it reads empty
    long long lo, hi;         // the canonical p12 looked up; a key outside
                              // [lo, hi) reads as absent, with no load
    int n, anchor_len, prefix_len, max_bucket, max_anchor_mm, device;
    int n_others, reserved;   // the other shards' records, 0 for none
    const int32_t* others;    // [n_others, n, kExactFields], or null
};
static_assert(sizeof(ExactArgs) == 176, "layout packed by ops/anchor_align");

// Built with FC2T_DETECT_STAMPS (ops/anchor_align.exact_stage_cycles),
// the first lane of each warp records its SM clock at the start and after
// each stage, kExactStamps values a warp into fc2t_estamps[warps,
// kExactStamps]. A stage ends where its results are first used (the
// warp's values, reduced over its lanes). Without it, ESTAMP is nothing.
#ifdef FC2T_DETECT_STAMPS
constexpr int kExactStamps = 5;
__device__ unsigned long long* fc2t_estamps = nullptr;
// Stamp `at` of the buffer: `dep` is stored first, so the clock is read
// only once the values it is made from have arrived.
__device__ __forceinline__ void exact_stamp(size_t at, unsigned dep) {
    volatile unsigned long long* p = fc2t_estamps;
    if (!p) return;
    p[at] = dep;
    p[at] = clock64();
}
#define ESTAMP(at, dep)                                              \
    do {                                                             \
        const unsigned d_ = __reduce_xor_sync(__activemask(), (dep)); \
        if ((threadIdx.x & 31) == 0) exact_stamp((at), d_);          \
    } while (0)
#else
#define ESTAMP(at, dep) \
    do {                \
    } while (0)
#endif

namespace {

using fc2t::holds;
using fc2t::kCntBits;
using fc2t::kCntMask;
using fc2t::kExactFields;
using fc2t::kLargeMm;
using fc2t::kLargePos;
using fc2t::kMaxShards;
using fc2t::kSlots;
using fc2t::mix_hash;

constexpr int kThreads = 128;
// Four lanes an anchor: lane 2p + t reads probe p's row of the table
// (t = 0) or of the neighbour table (t = 1).
constexpr int kLanesPerAnchor = 4;
constexpr int kAnchorsPerWarp = 8;
static_assert(kAnchorsPerWarp * kLanesPerAnchor == 32, "a warp's lanes");
constexpr int kAnchorsPerBlock = kThreads / kLanesPerAnchor;
constexpr unsigned kFull = 0xffffffffu;
// The neighbour table's lanes (index/hashtable.py NBR_LANES): one int4 a
// slot, as the table's.
constexpr int kNbrLanes = 4;
static_assert(kNbrLanes == fc2t::kLanes, "a slot is one int4 a table");
constexpr int kMaxAnchor = 32;
static_assert(kMaxAnchor == fc2t::kMaxKeyLen, "keys are 64-bit");
// A shard's record in partials mode is kExactFields int32
// (ops/anchor_align.EXACT_OPS' order): found, then count and least
// position of each orientation, exact and 1-mm ball; positions as uint32
// bit patterns. The combining mode holds its lanes' fields of the first
// kHeldShards other shards' records in registers (a data row of up to
// four shards).
constexpr int kHeldShards = 3;
// The range of a call that looks up every key (ops/anchor_align.EVERY_KEY):
// [0, kEveryKey).
constexpr long long kEveryKey = 0x7fffffffffffffff;
// A slot's matches, and its two 7-bit counts, packed into one sum: at
// most four matches (two slots, two probes of one coincident bucket).
constexpr int kCfShift = 3, kCrShift = 13;

// x over the four lanes of an anchor, summed or least.
template <typename T>
__device__ __forceinline__ T anchor_sum(T x) {
    x += __shfl_xor_sync(kFull, x, 1);
    return x + __shfl_xor_sync(kFull, x, 2);
}

__device__ __forceinline__ uint32_t anchor_min(uint32_t x) {
    x = min(x, __shfl_xor_sync(kFull, x, 1));
    return min(x, __shfl_xor_sync(kFull, x, 2));
}

// kRanged: the partials or the combining mode, which look up only the
// keys in [lo, hi); kCombine: the combining mode, an instantiation of its
// own. Its code sits under `if constexpr`, so that the single-table and
// the partials instantiations compile to the instructions they had
// without it (scripts/sass_digest.py); a dead branch under a plain `if`
// changed their register allocation.
template <bool kRanged, bool kCombine>
__global__ void __launch_bounds__(kThreads)
exact_kernel(const __grid_constant__ ExactArgs a) {
    const int lane = threadIdx.x & 31;
    const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
    if (warp * kAnchorsPerWarp >= a.n) return;  // whole warps leave
    // Lanes past the last anchor compute it again and write nothing:
    // every lane takes part in the shuffles.
    const int i_raw = warp * kAnchorsPerWarp + lane / kLanesPerAnchor;
    const bool real = i_raw < a.n;
    const int i = real ? i_raw : a.n - 1;
    const int sub = lane & (kLanesPerAnchor - 1);
    const int probe = sub >> 1;
    const bool nbr = sub & 1;
#ifdef FC2T_DETECT_STAMPS
    const size_t at = (size_t)warp * kExactStamps;
#endif
    ESTAMP(at, 0);
    const int al = a.anchor_len;
    // The combining mode: the other shards' records of the anchor, in
    // flight before the codes (load_now: where they are written).
    int32_t held[kCombine ? kHeldShards : 1][kExactFields];
    if constexpr (kCombine) {
#pragma unroll
        for (int t = 0; t < kHeldShards; ++t)
            if (t < a.n_others) {
                const int32_t* r =
                    a.others + ((size_t)t * a.n + i) * kExactFields;
#pragma unroll
                for (int f = 0; f < kExactFields; ++f)
                    held[t][f] = fc2t::load_now(r + f);
            }
    }

    // _exact_keys: the forward key (p12, s8) and its reverse complement's,
    // on the codes with those >= 4 zeroed; the lane's probe's salt and
    // the bucket count fly with the codes.
    const uint32_t salt = (uint32_t)a.meta[probe];
    const uint32_t n_buckets = (uint32_t)a.meta[2];
    const fc2t::ExactKey key =
        fc2t::exact_key(a.anchors + (size_t)i * al, al, a.prefix_len);
    const bool clean = key.clean, swap = key.swap;
    const unsigned long long cp = key.cp, cs = key.cs;
    ESTAMP(at + 1, (unsigned)(cp ^ cs) ^ salt ^ n_buckets);

    // The lane's row: its probe's bucket in its table; none for a key
    // outside [lo, hi), which another index shard owns.
    const bool own =
        !kRanged || ((long long)cp >= a.lo && (long long)cp < a.hi);
    const uint32_t h =
        own ? mix_hash((uint32_t)cp, (uint32_t)cs, salt) % n_buckets : 0u;
    const bool in = own && (long long)h < a.rows;
    const int4* row = reinterpret_cast<const int4*>(nbr ? a.ntable : a.table) +
                      (size_t)h * kSlots;
    const int4 empty = nbr ? make_int4(0, 0, 0, 0) : make_int4(-1, 0, 0, 0);
    int4 g[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) g[u] = in ? __ldg(row + u) : empty;
#ifdef FC2T_DETECT_STAMPS
    {
        // In the combining mode the stage ends when the other shards'
        // records have arrived too.
        unsigned dep = 0;
#pragma unroll
        for (int u = 0; u < kSlots; ++u)
            dep ^= g[u].x ^ g[u].y ^ g[u].z ^ g[u].w;
        if constexpr (kCombine) {
#pragma unroll
            for (int t = 0; t < kHeldShards; ++t)
                if (t < a.n_others)
#pragma unroll
                    for (int f = 0; f < kExactFields; ++f) dep ^= held[t][f];
        }
        ESTAMP(at + 2, dep);
    }
#endif

    // exact_partials: the table lane finds the slots that hold the key;
    // the neighbour-table lane of the same probe takes them by shuffle.
    // Every lane folds its own row's matching slots, then the anchor's
    // four lanes combine (counts and sums add, positions take the least).
    unsigned mine = 0;
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
        mine |= holds(g[u], (long long)cp, (uint32_t)cs) ? 1u << u : 0u;
    const unsigned other = __shfl_xor_sync(kFull, mine, 1);
    const unsigned match = nbr ? other : mine;
    int cnt = 0;  // matches | cnt_f << kCfShift | cnt_r << kCrShift
    long long s1f = 0, s1r = 0;
    uint32_t pf = kLargePos, pr = kLargePos, m1f = kLargePos,
             m1r = kLargePos;
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
        if (!(match >> u & 1)) continue;
        const int4 v = g[u];
        if (!nbr) {
            const unsigned packed = (unsigned)v.y;
            cnt += 1 + (int)((packed >> 16) & kCntMask) * (1 << kCfShift) +
                   (int)((packed >> (16 + kCntBits)) & kCntMask) *
                       (1 << kCrShift);
            pf = min(pf, (uint32_t)v.z);
            pr = min(pr, (uint32_t)v.w);
        } else {
            s1f += v.x;
            m1f = min(m1f, (uint32_t)v.y);
            s1r += v.z;
            m1r = min(m1r, (uint32_t)v.w);
        }
    }
    cnt = anchor_sum(cnt);
    s1f = anchor_sum(s1f);
    s1r = anchor_sum(s1r);
    pf = anchor_min(pf);
    pr = anchor_min(pr);
    m1f = anchor_min(m1f);
    m1r = anchor_min(m1r);
    bool found = (cnt & ((1 << kCfShift) - 1)) != 0;
    long long cf = cnt >> kCfShift & ((1 << (kCrShift - kCfShift)) - 1);
    long long cr = cnt >> kCrShift;
    if constexpr (kCombine) {
        // The other shards' records folded into the lanes' own partials
        // (on one table, the sums are they), in 64 bits, the held ones
        // first.
        const auto fold = [&](const int32_t* r) {
            found = found || r[0] != 0;
            cf += r[1];
            pf = min(pf, (uint32_t)r[2]);
            cr += r[3];
            pr = min(pr, (uint32_t)r[4]);
            s1f += r[5];
            m1f = min(m1f, (uint32_t)r[6]);
            s1r += r[7];
            m1r = min(m1r, (uint32_t)r[8]);
        };
#pragma unroll
        for (int t = 0; t < kHeldShards; ++t)
            if (t < a.n_others) fold(held[t]);
        for (int t = kHeldShards; t < a.n_others; ++t)
            fold(a.others + ((size_t)t * a.n + i) * kExactFields);
    }
    if (!kCombine && a.partials) {
        // Partials mode: the shard's record, lane `sub` writing fields
        // sub and sub + 4 (and lane 0 the ninth), then nothing more.
        if (real) {
            const int32_t rec[kExactFields] = {
                found, (int32_t)cf, (int32_t)pf, (int32_t)cr, (int32_t)pr,
                (int32_t)s1f, (int32_t)m1f, (int32_t)s1r, (int32_t)m1r};
            int32_t* dst = a.partials + (size_t)i * kExactFields;
#pragma unroll
            for (int f = 0; f < kExactFields; ++f)
                if ((f & (kLanesPerAnchor - 1)) == sub) dst[f] = rec[f];
        }
        ESTAMP(at + 3, found);
        ESTAMP(at + 4, 0);
        return;
    }

    // exact_finish, on every lane: the guard on the exact counts, the
    // orientation of the query, the frozen best-hit selection and the
    // MAPQ surrogate.
    const bool usable = found && clean;
    const long long cf_t = usable && cf <= a.max_bucket ? cf : 0;
    const long long cr_t = usable && cr <= a.max_bucket ? cr : 0;
    const long long s1f_t = usable ? s1f : 0;
    const long long s1r_t = usable ? s1r : 0;
    const long long exact_p = swap ? cr_t : cf_t;
    const long long exact_m = swap ? cf_t : cr_t;
    const uint32_t posx_p = swap ? pr : pf, posx_m = swap ? pf : pr;
    const long long s1_p = swap ? s1r_t : s1f_t;
    const long long s1_m = swap ? s1f_t : s1r_t;
    const uint32_t mp1_p = swap ? m1r : m1f, mp1_m = swap ? m1f : m1r;
    const long long n_exact = exact_p + exact_m;
    const long long total = n_exact + s1_p + s1_m;
    const bool any_exact = n_exact > 0, any_at_all = total > 0;
    const int m0 = any_exact ? 0 : (any_at_all ? 1 : kLargeMm);
    const long long n_best = any_exact ? n_exact : total;
    const bool has_p = any_exact ? exact_p > 0 : s1_p > 0;
    const int strand = has_p ? 0 : (any_at_all ? 1 : 2);
    const uint32_t pos_exact = strand == 0 && exact_p > 0   ? posx_p
                               : strand == 1 && exact_m > 0 ? posx_m
                                                            : kLargePos;
    const uint32_t pos_1mm = strand == 0   ? mp1_p
                             : strand == 1 ? mp1_m
                                           : kLargePos;
    const uint32_t pos = m0 == 0 ? pos_exact : (m0 == 1 ? pos_1mm : kLargePos);
    const int second_mm = n_best > 1 ? m0
                          : (m0 == 0 && total > n_exact) ? 1
                                                         : al + 1;
    const int q10 = 10 * (second_mm - m0);
    ESTAMP(at + 3, pos ^ strand ^ m0 ^ (unsigned)n_best ^ second_mm ^ q10 ^
                       found ^ clean);

    // The writes, shared by the anchor's lanes so that each store
    // instruction writes kAnchorsPerWarp neighbouring anchors: a 4-byte
    // field a lane, then pos, qual, and the two flags.
    if (real) {
        int32_t* f32 = sub == 0   ? a.strand
                       : sub == 1 ? a.mm
                       : sub == 2 ? a.n_best
                                  : a.second_mm;
        f32[i] = sub == 0   ? strand
                 : sub == 1 ? m0
                 : sub == 2 ? (int32_t)n_best
                            : second_mm;
        if (sub == 0) a.pos[i] = (int64_t)pos;
        if (sub == 1) a.qual[i] = n_best > 1 ? 0 : (q10 < 40 ? q10 : 40);
        if (sub >= 2)
            (sub == 2 ? a.aligned : a.resolved)[i] =
                sub == 2 ? m0 <= a.max_anchor_mm : found || !clean;
    }
    ESTAMP(at + 4, 0);
}

}  // namespace

// Host side: the C entry.

// The exact-first statistics and `resolved` of every anchor.
extern "C" int fc2t_exact_stats(const ExactArgs* a) {
    if (a->n <= 0) return 0;
    // The partials and combining modes look up the keys of [lo, hi); a
    // finish of every key and no other shards is the single table's.
    const bool ranged = a->partials != nullptr || a->n_others > 0 ||
                        a->lo != 0 || a->hi != kEveryKey;
    if (a->anchor_len < 1 || a->anchor_len > kMaxAnchor ||
        a->prefix_len < 1 || a->prefix_len >= a->anchor_len ||
        a->anchor_len - a->prefix_len > 8 || a->rows < 1 ||
        a->n_others < 0 || a->n_others >= kMaxShards ||
        (a->n_others > 0) != (a->others != nullptr) ||
        (a->partials != nullptr && a->n_others > 0) ||
        (a->partials == nullptr && a->aligned == nullptr))
        return -(int)cudaErrorInvalidValue;
    int dev = -1;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -(int)err;
    if (dev != a->device) return -(int)cudaErrorInvalidDevice;
    const unsigned blocks =
        (unsigned)((a->n + kAnchorsPerBlock - 1) / kAnchorsPerBlock);
    const cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
    if (a->partials)
        exact_kernel<true, false><<<blocks, kThreads, 0, stream>>>(*a);
    else if (ranged)
        exact_kernel<true, true><<<blocks, kThreads, 0, stream>>>(*a);
    else
        exact_kernel<false, false><<<blocks, kThreads, 0, stream>>>(*a);
    err = cudaGetLastError();
    return err == cudaSuccess ? 1 : -(int)err;
}

#ifdef FC2T_DETECT_STAMPS
// Where the next launches record their stage clocks (null: nowhere).
extern "C" int fc2t_exact_stamps(void* stamps) {
    unsigned long long* p = static_cast<unsigned long long*>(stamps);
    const cudaError_t err = cudaMemcpyToSymbol(fc2t_estamps, &p, sizeof p);
    return err == cudaSuccess ? 0 : -(int)err;
}
#endif
