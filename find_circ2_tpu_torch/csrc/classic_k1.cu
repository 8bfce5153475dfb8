// K1's classic enumeration (K-d) on one index table, and the compaction of
// K1 v4's exact-first fallback slice (K-c): one warp per anchor, one
// launch per call; the compaction one block per batch.
//
// Replaces, on one index table, the plain versions in
// find_circ2_tpu_torch/ops/anchor_align.py: enumerate_variants (the
// 1 + 3a <= 1-mismatch variants of an anchor as forward and reverse-
// complement keys), _canonical, index/hashtable.mix_hash for both salts,
// _bucket_rows (a gather_rows launch there, with gather_rows_multi for
// ext_id), candidate_stats (per strand slot count and first position,
// with the §2b extras each slot's ext row), variant_metadata and
// finalize_hits with _hits (the frozen SPEC §2 best hit); and the slice of
// _fast_pair: a stable argsort of `resolved`, its first k indices, the
// overflow flag and the scatter of the slice's hits back (index_copy).
// The reference computes the same as XLA programs, not Pallas
// (find_circ2_tpu/ops/anchor_align.py:140 candidate_stats, :59, :123,
// :271 finalize_hits; the slice of align_anchor_pair_fast at :496-527).
// On an index shard of the sharded engine the enumeration runs in partials
// mode: the shard's part of candidate_stats reduced to the eight numbers a
// slot's finish reads (the reference's finalize_hits with axis_name psums
// and pmins the whole [n, 2V] arrays), one record a slot. One shard of the
// data row, the first on the anchors' device, launched after the others,
// runs in combining mode instead: its warp reduces its own record as the
// partials mode does, keeps it in registers, folds in the other shards'
// records of its slot and finishes (csrc/shard_finish.cuh, as the
// probe's combining mode does), lanes 0..6 writing one hit
// field each, at slots[s] in slot mode (in place over the probe's hits, as
// refill_slice writes). The finish now sits in this epilogue: what bounds
// it is the other shards' records, read once (32 bytes a shard a slot, two
// 16-byte loads), and about 100 integer operations a slot, far under the
// warp's row round trip; the records' loads are issued at the warp's
// start, before the slot's and the anchor's loads, and the first
// kHeldShards wait in registers, so their round trip overlaps the key
// build and the row round trip. A launch of its own costs each phase of a
// data row its fixed start once more than it needs. Thread-block clusters
// and distributed shared memory would only help when all of a row's shards
// lie on one card, which is the test layout and not a deployment, and
// programmatic dependent launch overlaps a launch but keeps it. A shard
// holds only the keys whose canonical p12 lies in its range [lo, hi)
// (ops/anchor_align.key_ranges), so there a variant whose canonical key
// lies outside issues no hash and no row load and counts 0 with LARGE_POS,
// as a key the shard lacks does. Substitutions keep p12 at the suffix
// positions of the canonical orientation, so an anchor's owner shard sees
// most of its 61 variants and the others a few: the rows in flight on a
// shard fall from all of a data row's to about its share. A warp still
// takes one slot, however few of its variants the shard owns: the slice
// and the redo are bound by the rate of random rows (classic_stage_cycles'
// row round trip), which the skipped loads relieve, and a warp that took
// several slots would serialise their key builds (PERF.md gives the stage
// clocks of both partials modes). The range test is compiled into the
// partials and combining modes only (kRanged): on one table it cost the
// redo's warps time for nothing.
// The plain versions are about 270 eager kernels a detect batch's
// fallback slice and 546 an explore chunk's K1.
//
// What bounds it on this card: bytes. Each anchor reads 61 x 2 random
// 32-byte bucket rows (about 3.9 KB); with the extras also the ext_id
// word of each matching slot and the ext row (120 bytes) of each variant
// that has one, and it writes 122 counts, 122 first positions and
// 122 x 15 extra positions (about 16 KB). Its arithmetic, a few hundred
// 32-bit operations a variant, is less. chip_smoke.py computes the bound
// from each run's data. Each row is a random access into a table larger
// than the L2, so the rate of random row fetches, not of bytes, sets the
// main round trip; the main path's grids fill less than one wave, so a
// warp's chain of dependent steps sets the rest. The design, chosen
// from the stage clocks (classic_stage_cycles), shortens that chain and
// fetches fewer random rows:
//
//  - One warp an anchor, four a block. The anchor's base keys are an OR
//    over the warp of each lane's digit at its place value (the digits'
//    2-bit fields are disjoint, so the OR is the sum), not a serial loop
//    of shuffles.
//  - Lane l takes the canonical variants l and l + 32 (V = 61 <= 64) in
//    enumerate_variants' order, builds each key from the base keys and
//    the substitution's delta, swaps to the canonical key, hashes both
//    salts and issues all its table loads (16 bytes at a time) before it
//    uses any of them: eight loads in flight a lane.
//  - Sums and minima over the warp with __reduce_add_sync and
//    __reduce_min_sync; lanes 0..6 write one hit field each.
//  - With the extras, the warp copies ext row 0 (the dummy row of every
//    variant without a row of its own) into shared memory at the start.
//    After the fold, only a matching slot's ext_id word is loaded (a few
//    a warp, where every variant's two 8-byte ext_id rows were as many
//    random fetches as the table's), flying while the warp writes the
//    counts, positions and hits; then the rows of the few variants that
//    have one come into shared memory in one round trip (cp.async,
//    8-byte pieces, consecutive lanes on consecutive pieces of a row).
//    Only then does the warp write the anchor's whole [2V, K - 1] block
//    of `extras`, as 16-byte streaming stores (__stcs: the pair kernel
//    reads back only the best slots), each lane's element map stepped
//    without a division and each slot's source looked up in shared
//    memory. Written earlier, while other warps' table rows are still on
//    their way, the 30 MB of an explore chunk's extras slowed those
//    random reads by more than they overlapped. The kernel asks for a
//    shared-memory carveout that leaves the L1 about 92 KB.
//  - The slice: one block of 1024 threads. Each thread loads its run of
//    consecutive flags first (one 8-byte load a thread at 8192 flags),
//    counts the unresolved, and one block-wide scan gives every flag's
//    rank and the unresolved total: one round trip to device memory and
//    two barriers. It writes the slice's anchor indices in the stable
//    argsort's order (the unresolved first, then the resolved, each in
//    index order) and the 0-d overflow flag that detect's core reads on
//    the device; then the enumeration in "slot" mode reads
//    anchors[slots[s]] and writes its hits over the exact probe's at
//    slots[s], in place. Nothing waits for the device.
//
// Kept bit for bit, against the plain version: first_pos is not masked by
// the count (a slot guarded to 0, or of a dirty anchor, keeps its least
// position and its extras their row); a dirty anchor (a code >= 4) is
// looked up on its codes with those zeroed and counts 0; the guard
// applies to each strand slot after the swap; when a key's two buckets
// are one bucket both probes match its slot, so its counts and its ext
// row ids add twice (ROADMAP.md §3), and a doubled row id at or past the
// last ext row reads LARGE_POS; row id 0 reads row 0; a bucket at or past
// the table's rows reads empty.
//
// Plain C interface for ctypes: one packed argument buffer an entry
// (ClassicArgs, CompactArgs). Each entry returns the kernels it launched
// (1, or 0 for nothing to do), or minus a CUDA error.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "cuckoo.cuh"
#include "shard_finish.cuh"

// The arguments of one enumeration, packed by ops/anchor_align.py into
// one buffer. Three modes: hits only (count == nullptr, slots ==
// nullptr); the per-slot statistics too (count and first_pos, and with
// ext_id the extras); and the fallback slice (slots != nullptr): slot s
// enumerates anchors[slots[s]] and writes its hits at slots[s]. With
// `partials` (an index shard's part; no statistics, the hit pointers
// null) the full or slot mode writes each slot's kClassicFields record
// at row s instead of its hits. The combining mode (no statistics, the
// hit pointers set, n_others >= 1 or a range other than every key)
// looks up the keys of [lo, hi), folds in the other shards' records of
// each slot, `others` row s, and writes its hits as the full or slot
// mode does.
struct ClassicArgs {
    const uint8_t* anchors;   // [n_anchors, anchor_len] codes
    const int32_t* table;     // [rows, SLOTS * LANES] cuckoo table
    const int32_t* meta;      // (salt0, salt1, n_buckets, ...), uint32 bits
    const int32_t* ext_id;    // [rows, SLOTS], or null: no extras
    const int32_t* ext;       // [ext_rows, 2 * ext_width], uint32 bits
    const int64_t* slots;     // [n]: the fallback slice's anchors, or null
    uint8_t* aligned;         // [n] bool; the AnchorHits fields, then
    int64_t* pos;             // [n], uint32 values
    int32_t* strand;          // [n]
    int32_t* mm;              // [n]
    int32_t* n_best;          // [n]
    int32_t* second_mm;       // [n]
    int32_t* qual;            // [n]
    int32_t* count;           // [n, 2V], or null
    int64_t* first_pos;       // [n, 2V], uint32 values, or null
    int64_t* extras;          // [n, 2V, ext_width], uint32 values, or null
    void* stream;
    long long rows;           // table rows; a bucket at or past it reads empty
    long long ext_rows;       // a row id at or past it reads LARGE_POS
    int n, anchor_len, prefix_len, max_bucket, max_anchor_mm, ext_width,
        device, reserved;
    long long lo, hi;         // the canonical p12 looked up; a key outside
                              // [lo, hi) reads as absent, with no load
    int32_t* partials;        // [n, kClassicFields], or null
    const int32_t* others;    // [n_others, n, kClassicFields], or null
    int n_others, reserved2;
};
static_assert(sizeof(ClassicArgs) == 224, "layout packed by ops/anchor_align");

// The arguments of one compaction of the fallback slice.
struct CompactArgs {
    const uint8_t* resolved;  // [n] bool
    int64_t* slots;           // [k] out: the slice's anchor indices
    uint8_t* overflow;        // 0-d bool out: unresolved anchors > k
    void* stream;
    long long n, k;
    int device, reserved;
};
static_assert(sizeof(CompactArgs) == 56, "layout packed by ops/anchor_align");

// Built with FC2T_CLASSIC_STAMPS (ops/anchor_align.classic_stage_cycles,
// compact_stage_cycles), lane 0 of each enumeration warp records its SM
// clock at the start and after each stage, kClassicStamps values a warp
// into fc2t_cstamps[n, kClassicStamps], and thread 0 of the compaction
// block kCompactStamps values. A stage ends where its results are first
// used. Without it, CSTAMP is nothing.
#ifdef FC2T_CLASSIC_STAMPS
constexpr int kClassicStamps = 7, kCompactStamps = 4;
__device__ unsigned long long* fc2t_cstamps = nullptr;
// Stamp `at` of the buffer: `dep` is stored first, so the clock is read
// only once the values it is made from have arrived.
__device__ __forceinline__ void classic_stamp(size_t at, unsigned dep) {
    volatile unsigned long long* p = fc2t_cstamps;
    if (!p) return;
    p[at] = dep;
    p[at] = clock64();
}
#define CSTAMP(at, dep) classic_stamp((at), (unsigned)(dep))
#else
#define CSTAMP(at, dep) \
    do {                \
    } while (0)
#endif

namespace {

using fc2t::holds;
using fc2t::kClassicFields;
using fc2t::kCntBits;
using fc2t::kCntMask;
using fc2t::kLargeMm;
using fc2t::kLargePos;
using fc2t::kMaxShards;
using fc2t::kSlots;
using fc2t::mix_hash;

// A shard's record in partials mode is kClassicFields int32: the counts
// of the two exact slots (0 and V), the counts summed over each strand
// half, and the least first position over the slots whose count is
// above 0 of slot 0, slot V, slots 1..V-1 and slots V+1..2V-1 (uint32
// bit patterns, LARGE_POS for none): all that finalize_hits reads, since
// mm is 0 only at the exact slots and it selects only slots with a
// count. The combining mode holds the first kHeldShards other shards'
// records of its slot in registers (a data row of two shards, the
// engine's; eight registers a record, which the redo's grid of a block
// an SM past one wave cannot spare for more).
constexpr int kHeldShards = 1;
static_assert(kClassicFields * 4 == 2 * sizeof(int4), "a record: two int4");

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                  // anchors a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPerLane = 2;                // variants a lane: V <= 64
constexpr int kMaxAnchor = 21;             // V = 1 + 3a <= 32 * kPerLane
constexpr int kMaxExtWidth = 15;           // K - 1, explore's K <= 16
constexpr int kCompactThreads = 1024;
// The range of a call that looks up every key (ops/anchor_align.EVERY_KEY):
// [0, kEveryKey).
constexpr long long kEveryKey = 0x7fffffffffffffff;
constexpr int kFlagsPerWord = 8;           // one 8-byte load of `resolved`
constexpr int kCachedWords = 4;            // a thread's words in registers
// The enumeration's shared-memory carveout with the extras, in percent of
// the most an SM has: room for the four resident blocks of an explore
// chunk (34 KB each), the L1 that the table rows go through keeping about
// 92 KB.
constexpr int kCarveout = 70;
constexpr int kMaxDevices = 64;

// The place value of anchor digit j in each key (_weights): the forward
// (prefix, suffix) key and the reverse complement's; 0 past the anchor.
struct Weights {
    long long wp, ws, wpr, wsr;
};

__device__ __forceinline__ Weights weights(int j, int al, int pk) {
    const int sk = al - pk;
    if (j >= al) return {0, 0, 0, 0};
    return {j < pk ? 1ll << (2 * (pk - 1 - j)) : 0,
            j >= pk ? 1ll << (2 * (al - 1 - j)) : 0,
            j >= al - pk ? 1ll << (2 * (j - (al - pk))) : 0,
            j < sk ? 1ll << (2 * j) : 0};
}

// The OR of x over the warp.
__device__ __forceinline__ long long warp_or(long long x) {
    const unsigned long long u = (unsigned long long)x;
    const unsigned lo = __reduce_or_sync(kFull, (unsigned)u);
    const unsigned hi = __reduce_or_sync(kFull, (unsigned)(u >> 32));
    return (long long)((unsigned long long)hi << 32 | lo);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// A warp's shared memory with the extras, in 32-bit words: a place for
// each variant's ext row (W = 2 * ext_width words), ext row 0, each
// variant's ext row id (-1: past the rows), the list of the variants
// whose rows are copied and where each strand slot's words start. Even,
// so each warp's rows lie on 8 bytes.
__host__ __device__ constexpr size_t warp_smem_words(int V, int W) {
    return (size_t)(V + 1) * W + 4 * 32 * kPerLane;
}

// Slot s's anchor, by the warp; `stage` is the warp's shared memory.
// kExtras: the call has the extras (ext_id and ext); kRanged: it looks up
// only the keys in [lo, hi) (the partials or the combining mode);
// kCombine: the combining mode, an instantiation of its own so that its
// held records and fold cost the partials mode no registers; its code
// sits under `if constexpr`, so that the other instantiations compile to
// the instructions they had without it (scripts/sass_digest.py).
template <bool kExtras, bool kRanged, bool kCombine>
__device__ __forceinline__ void enumerate(const ClassicArgs& a, int s,
                                          int lane, uint32_t* stage) {
#ifdef FC2T_CLASSIC_STAMPS
    const size_t at = (size_t)s * kClassicStamps;
    if (lane == 0) CSTAMP(at, 0);
#endif
    // The combining mode: the other shards' records of the slot, in
    // flight before the slot's and the anchor's loads (load_now: where
    // they are written), every lane loading each (one address a warp).
    int4 held[kCombine ? kHeldShards : 1][2];
    if constexpr (kCombine) {
#pragma unroll
        for (int t = 0; t < kHeldShards; ++t)
            if (t < a.n_others) {
                const int4* r = reinterpret_cast<const int4*>(
                    a.others + ((size_t)t * a.n + s) * kClassicFields);
                held[t][0] = fc2t::load_now(r);
                held[t][1] = fc2t::load_now(r + 1);
            }
    }
    const long long anchor = a.slots ? a.slots[s] : s;
    const int al = a.anchor_len, pk = a.prefix_len, V = 1 + 3 * al;
    const uint8_t* anc = a.anchors + anchor * al;
    // With the extras: ext row 0, the dummy row of every variant without
    // a row of its own, flies into shared memory while the keys are built.
    const int K1 = a.ext_width, W = 2 * K1;
    const int2* ext = reinterpret_cast<const int2*>(a.ext);
    uint32_t* row0 = stage + (size_t)V * W;
    if (kExtras) {
        if (lane < K1)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                             smem_addr(row0 + 2 * lane)),
                         "l"(ext + lane));
        asm volatile("cp.async.commit_group;\n" ::);
    }

    // enumerate_variants: lane j holds code j; the base keys on the codes
    // with those >= 4 zeroed, each digit in its own 2-bit field, so an OR
    // over the warp sums them; `clean` over the whole anchor.
    const int code = lane < al ? anc[lane] : 0;
    const bool clean = __all_sync(kFull, lane >= al || code < 4);
#ifdef FC2T_CLASSIC_STAMPS
    if (lane == 0) CSTAMP(at + 1, clean);
#endif
    const int q = code < 4 ? code : 0;
    const Weights mine = weights(lane, al, pk);
    const long long p12 = warp_or(q * mine.wp);
    const long long s8 = warp_or(q * mine.ws);
    const long long p12r = warp_or((3 - q) * mine.wpr);
    const long long s8r = warp_or((3 - q) * mine.wsr);
#ifdef FC2T_CLASSIC_STAMPS
    if (lane == 0) CSTAMP(at + 2, p12 ^ s8 ^ p12r ^ s8r);
#endif

    // Each of the lane's variants: its canonical key, both buckets, and
    // every row load in flight before any is used.
    const uint32_t n_buckets = (uint32_t)a.meta[2];
    const uint32_t salt[2] = {(uint32_t)a.meta[0], (uint32_t)a.meta[1]};
    bool act[kPerLane], swp[kPerLane];
    long long cp[kPerLane];
    uint32_t cs[kPerLane], hb[kPerLane][2];
    int4 g[kPerLane][2][kSlots];
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
        const int v = lane + 32 * t;
        act[t] = v < V;
        // Variant 1 + 3j + (r - 1): position j takes (q_j + r) % 4.
        const int vv = act[t] ? v : 0;
        const int j = vv > 0 ? (vv - 1) / 3 : 0;
        const int qj = __shfl_sync(kFull, q, j);
        const long long d = vv > 0 ? ((qj + (vv - 1) % 3 + 1) & 3) - qj : 0;
        const Weights wt = weights(j, al, pk);
        const long long fp = p12 + d * wt.wp, fs = s8 + d * wt.ws;
        const long long rp = p12r - d * wt.wpr, rs = s8r - d * wt.wsr;
        swp[t] = rp < fp || (rp == fp && rs < fs);
        cp[t] = swp[t] ? rp : fp;
        cs[t] = (uint32_t)(swp[t] ? rs : fs);
        // A key outside [lo, hi) (another index shard's) is not looked up.
        const bool own =
            act[t] && (!kRanged || (cp[t] >= a.lo && cp[t] < a.hi));
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            const uint32_t h =
                !kRanged || own
                    ? mix_hash((uint32_t)cp[t], cs[t], salt[p]) % n_buckets
                    : 0u;
            const bool in = own && (long long)h < a.rows;
            const int4* tr = reinterpret_cast<const int4*>(a.table) +
                             (size_t)h * kSlots;
            hb[t][p] = h;
#pragma unroll
            for (int u = 0; u < kSlots; ++u)
                g[t][p][u] = in ? __ldg(tr + u) : make_int4(-1, 0, 0, 0);
        }
    }
    // The combining mode: the held records folded while the rows are on
    // their way, counts in 64 bits.
    fc2t::ClassicSums sums = fc2t::classic_none();
    if constexpr (kCombine) {
#pragma unroll
        for (int t = 0; t < kHeldShards; ++t)
            if (t < a.n_others) {
                const int32_t r[kClassicFields] = {
                    held[t][0].x, held[t][0].y, held[t][0].z, held[t][0].w,
                    held[t][1].x, held[t][1].y, held[t][1].z, held[t][1].w};
                fc2t::fold(sums, r);
            }
    }
#ifdef FC2T_CLASSIC_STAMPS
    {
        unsigned dep = 0;
#pragma unroll
        for (int t = 0; t < kPerLane; ++t)
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
                for (int u = 0; u < kSlots; ++u)
                    dep ^= g[t][p][u].x ^ g[t][p][u].y ^ g[t][p][u].z ^
                           g[t][p][u].w;
        // In the combining mode the stage ends when the other shards'
        // records have arrived too.
        if constexpr (kCombine) {
#pragma unroll
            for (int t = 0; t < kHeldShards; ++t)
                if (t < a.n_others)
#pragma unroll
                    for (int w = 0; w < 2; ++w)
                        dep ^= held[t][w].x ^ held[t][w].y ^ held[t][w].z ^
                               held[t][w].w;
        }
        dep = __reduce_xor_sync(kFull, dep);
        if (lane == 0) CSTAMP(at + 3, dep);
    }
#endif

    // candidate_stats: both probes folded (counts and ext row ids add,
    // positions take the least), each strand slot swapped into '+' / '-',
    // the `valid` mask, then the guard on each slot. With the extras, the
    // ext_id word of each matching slot only (a few a warp) is loaded,
    // all in flight together; an unmatched slot adds 0.
    int cnt_p[kPerLane], cnt_m[kPerLane];
    uint32_t pos_p[kPerLane], pos_m[kPerLane];
    int x_id[kPerLane][2][kSlots];
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
        int cf = 0, cr = 0;
        uint32_t pf = kLargePos, pr = kLargePos;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
            for (int u = 0; u < kSlots; ++u) {
                const int4 r = g[t][p][u];
                const bool m = holds(r, cp[t], cs[t]);
                x_id[t][p][u] = m && kExtras
                                    ? __ldg(a.ext_id +
                                            (size_t)hb[t][p] * kSlots + u)
                                    : 0;
                if (!m) continue;
                cf += (int)(((unsigned)r.y >> 16) & kCntMask);
                cr += (int)(((unsigned)r.y >> (16 + kCntBits)) & kCntMask);
                pf = min(pf, (uint32_t)r.z);
                pr = min(pr, (uint32_t)r.w);
            }
        }
        int cp_ = swp[t] ? cr : cf, cm_ = swp[t] ? cf : cr;
        if (!clean) cp_ = cm_ = 0;
        cnt_p[t] = cp_ > a.max_bucket ? 0 : cp_;
        cnt_m[t] = cm_ > a.max_bucket ? 0 : cm_;
        pos_p[t] = swp[t] ? pr : pf;
        pos_m[t] = swp[t] ? pf : pr;
    }

    if (!kExtras && (kCombine || a.partials)) {
        // Partials mode: the record, one field a lane of lanes 0..7;
        // combining mode: the record with the other shards' folded in,
        // then the finish.
        int sp = 0, sm = 0;
        uint32_t lp = kLargePos, lm = kLargePos;
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) {
            sp += cnt_p[t];
            sm += cnt_m[t];
            const int v = lane + 32 * t;
            if (!act[t] || v == 0) continue;
            if (cnt_p[t] > 0) lp = min(lp, pos_p[t]);
            if (cnt_m[t] > 0) lm = min(lm, pos_m[t]);
        }
        sp = (int)__reduce_add_sync(kFull, (unsigned)sp);
        sm = (int)__reduce_add_sync(kFull, (unsigned)sm);
        lp = __reduce_min_sync(kFull, lp);
        lm = __reduce_min_sync(kFull, lm);
        const int c0 = __shfl_sync(kFull, cnt_p[0], 0);
        const int cv = __shfl_sync(kFull, cnt_m[0], 0);
        const uint32_t p0 = __shfl_sync(kFull, pos_p[0], 0);
        const uint32_t pv = __shfl_sync(kFull, pos_m[0], 0);
        const int32_t rec[kClassicFields] = {
            c0, cv, sp, sm, (int32_t)(c0 > 0 ? p0 : kLargePos),
            (int32_t)(cv > 0 ? pv : kLargePos), (int32_t)lp, (int32_t)lm};
        if constexpr (!kCombine) {
            int32_t* dst = a.partials + (size_t)s * kClassicFields;
#pragma unroll
            for (int f = 0; f < kClassicFields; ++f)
                if (lane == f) dst[f] = rec[f];
#ifdef FC2T_CLASSIC_STAMPS
            if (lane == 0 && fc2t_cstamps) {
                CSTAMP(at + 4, lp ^ lm);
                fc2t_cstamps[at + 5] = fc2t_cstamps[at + 6] =
                    fc2t_cstamps[at + 4];
            }
#endif
            return;
        } else {
            // Combining mode: the shard's own record folded into the held
            // ones' sums, then any records past them.
            fc2t::fold(sums, rec);
            for (int t = kHeldShards; t < a.n_others; ++t)
                fc2t::fold(sums,
                           a.others + ((size_t)t * a.n + s) * kClassicFields);
            const fc2t::Hit hit =
                fc2t::classic_finish(sums, a.max_anchor_mm, a.anchor_len);
            // One field a lane of lanes 0..6, as predicated stores (a
            // switch on the lane branches the warp seven ways).
            if (lane == 0) a.aligned[anchor] = hit.aligned;
            if (lane == 1) a.pos[anchor] = (int64_t)hit.pos;
            if (lane == 2) a.strand[anchor] = hit.strand;
            if (lane == 3) a.mm[anchor] = hit.mm;
            if (lane == 4) a.n_best[anchor] = hit.n_best;
            if (lane == 5) a.second_mm[anchor] = hit.second_mm;
            if (lane == 6) a.qual[anchor] = hit.qual;
#ifdef FC2T_CLASSIC_STAMPS
            if (lane == 0 && fc2t_cstamps) {
                CSTAMP(at + 4, hit.pos ^ hit.n_best);
                fc2t_cstamps[at + 5] = fc2t_cstamps[at + 6] =
                    fc2t_cstamps[at + 4];
            }
#endif
            return;
        }
    }

    if (a.count) {
        const size_t row = (size_t)s * 2 * V;
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) {
            const int v = lane + 32 * t;
            if (!act[t]) continue;
            a.count[row + v] = cnt_p[t];
            a.count[row + V + v] = cnt_m[t];
            a.first_pos[row + v] = (int64_t)pos_p[t];
            a.first_pos[row + V + v] = (int64_t)pos_m[t];
        }
    }

    // finalize_hits: the exact slots 0 and V are lane 0's first variant.
    int tot = 0, half = 0;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
        tot += cnt_p[t] + cnt_m[t];
        half += cnt_p[t];
    }
    const int total = (int)__reduce_add_sync(kFull, (unsigned)tot);
    const int half_p = (int)__reduce_add_sync(kFull, (unsigned)half);
    const int exact_p = __shfl_sync(kFull, cnt_p[0], 0);
    const int exact_m = __shfl_sync(kFull, cnt_m[0], 0);
    const int n_exact = exact_p + exact_m;
    const bool any_exact = n_exact > 0, any_at_all = total > 0;
    const int m0 = any_exact ? 0 : (any_at_all ? 1 : kLargeMm);
    const int n_best = any_exact ? n_exact : total;
    const bool has_p = any_exact ? exact_p > 0 : half_p > 0;
    const int strand = has_p ? 0 : (any_at_all ? 1 : 2);
    // The least first_pos over slots with count > 0 at mm == m0 (0 only
    // at the exact slots) on the best strand.
    uint32_t best = kLargePos;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
        const int v = lane + 32 * t;
        if (!act[t] || (v == 0 ? 0 : 1) != m0) continue;
        if (strand == 0 && cnt_p[t] > 0) best = min(best, pos_p[t]);
        if (strand == 1 && cnt_m[t] > 0) best = min(best, pos_m[t]);
    }
    best = __reduce_min_sync(kFull, best);
    // _hits, one field a lane.
    const int second_mm = n_best > 1 ? m0
                          : (m0 == 0 && total > n_exact) ? 1
                                                         : al + 1;
    const int q10 = 10 * (second_mm - m0);
    switch (lane) {
        case 0: a.aligned[anchor] = m0 <= a.max_anchor_mm; break;
        case 1: a.pos[anchor] = (int64_t)best; break;
        case 2: a.strand[anchor] = strand; break;
        case 3: a.mm[anchor] = m0; break;
        case 4: a.n_best[anchor] = n_best; break;
        case 5: a.second_mm[anchor] = second_mm; break;
        case 6: a.qual[anchor] = n_best > 1 ? 0 : (q10 < 40 ? q10 : 40);
    }
#ifdef FC2T_CLASSIC_STAMPS
    if (lane == 0) {
        CSTAMP(at + 4, best);
        if (!kExtras && fc2t_cstamps)
            fc2t_cstamps[at + 5] = fc2t_cstamps[at + 6] = fc2t_cstamps[at + 4];
    }
#endif

    if (!kExtras) return;
    // The extras: each variant's ext row, the sum of its matching slots'
    // ext_id words over both probes; row id 0 (in shared memory since the
    // start) the dummy row, an id at or past ext_rows (a doubled one)
    // LARGE_POS. The other rows, a few a warp, come into shared memory in
    // one round trip (cp.async, 8-byte pieces, consecutive lanes on
    // consecutive pieces of a row). Only then does the warp write its
    // extras: written while other warps' table rows are still on their
    // way, they slow those reads more than they gain.
    int* row_of = reinterpret_cast<int*>(row0 + W);
    int* list = row_of + 32 * kPerLane;
    int* src = list + 32 * kPerLane;
    bool copy[kPerLane];
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
        long long rid = 0;
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int u = 0; u < kSlots; ++u) rid += x_id[t][p][u];
        const int row = rid >= 0 && rid < a.ext_rows ? (int)rid : -1;
        copy[t] = act[t] && row > 0;
        if (act[t]) row_of[lane + 32 * t] = row;
    }
    // list[i]: the i-th variant, in order, whose row is copied.
    const unsigned lt = (1u << lane) - 1u;
    const unsigned c0 = __ballot_sync(kFull, copy[0]);
    const unsigned c1 = __ballot_sync(kFull, copy[1]);
    const int n0 = __popc(c0), rows = n0 + __popc(c1);
    if (copy[0]) list[__popc(c0 & lt)] = lane;
    if (copy[1]) list[n0 + __popc(c1 & lt)] = lane + 32;
    __syncwarp();
    {
        // Piece i * K1 + c: words 2c and 2c + 1 of variant list[i]'s row;
        // lane l takes pieces l, l + 32, ...
        const int q32 = 32 / K1, r32 = 32 - q32 * K1;
        int i = lane / K1, c = lane - i * K1;
        while (i < rows) {
            const int v = list[i];
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                             smem_addr(stage + (size_t)v * W + 2 * c)),
                         "l"(ext + (size_t)row_of[v] * K1 + c));
            i += q32;
            c += r32;
            if (c >= K1) {
                c -= K1;
                ++i;
            }
        }
        asm volatile("cp.async.commit_group;\n" ::);
    }
    // src[sl]: where strand slot sl's K1 words start in the warp's shared
    // memory (-1: LARGE_POS), in its variant's row: the forward half for
    // a '+' slot and the reverse half for a '-' slot, exchanged when the
    // variant swapped.
    const unsigned long long swaps =
        (unsigned long long)__ballot_sync(kFull, swp[0]) |
        (unsigned long long)__ballot_sync(kFull, swp[1]) << 32;
    for (int sl = lane; sl < 2 * V; sl += 32) {
        const bool minus = sl >= V;
        const int v = minus ? sl - V : sl, row = row_of[v];
        const int half = minus != (bool)((swaps >> v) & 1ull) ? K1 : 0;
        src[sl] = row < 0 ? -1 : (row == 0 ? V * W : v * W) + half;
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();
#ifdef FC2T_CLASSIC_STAMPS
    if (lane == 0) CSTAMP(at + 5, rows);
#endif
    // The anchor's [2V, K1] block of `extras`, elements 2i and 2i + 1 a
    // 16-byte streaming store; lane l's element 2l steps 64 a store, its
    // slot and word stepped without a division.
    longlong2* dst = reinterpret_cast<longlong2*>(a.extras) +
                     (size_t)s * V * K1;
    const int q64 = 64 / K1, r64 = 64 - q64 * K1;
    int slot = 2 * lane / K1, c = 2 * lane - slot * K1;
    for (int i = lane; i < V * K1; i += 32) {
        const int o0 = src[slot];
        const int o1 = c + 1 < K1 ? o0 : src[slot + 1];
        const int c1 = c + 1 < K1 ? c + 1 : 0;
        const uint32_t x0 = o0 < 0 ? kLargePos : stage[o0 + c];
        const uint32_t x1 = o1 < 0 ? kLargePos : stage[o1 + c1];
        __stcs(dst + i, make_longlong2(x0, x1));
        slot += q64;
        c += r64;
        if (c >= K1) {
            c -= K1;
            ++slot;
        }
    }
#ifdef FC2T_CLASSIC_STAMPS
    if (lane == 0) CSTAMP(at + 6, slot);
#endif
}

template <bool kExtras, bool kRanged, bool kCombine>
__global__ void __launch_bounds__(kThreads)
classic_kernel(const __grid_constant__ ClassicArgs a) {
    extern __shared__ __align__(16) uint32_t smem_all[];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    uint32_t* stage =
        smem_all + (size_t)w * warp_smem_words(1 + 3 * a.anchor_len,
                                                2 * a.ext_width);
    const int s = blockIdx.x * kWarps + w;
    if (s < a.n) enumerate<kExtras, kRanged, kCombine>(a, s, lane, stage);
}

// The flags of word `wd` of `resolved` (flags 8 wd .. 8 wd + 7, a byte
// each): one 8-byte load when the word lies whole inside [0, n) and the
// buffer is on 8 bytes, else a byte at a time, those at or past n read as
// resolved (1).
__device__ __forceinline__ uint2 flag_word(const uint8_t* resolved,
                                          long long n, long long wd,
                                          bool vec) {
    const long long j = wd * kFlagsPerWord;
    if (vec && j + kFlagsPerWord <= n)
        return __ldg(reinterpret_cast<const uint2*>(resolved) + wd);
    uint32_t b[kFlagsPerWord];
#pragma unroll
    for (int i = 0; i < kFlagsPerWord; ++i)
        b[i] = j + i < n ? resolved[j + i] : 1u;
    return make_uint2(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24,
                      b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24);
}

// The unresolved (zero) flags of a word as a mask: bit b for flag b.
__device__ __forceinline__ unsigned zero_flags(uint2 x) {
    const unsigned lo = __vcmpeq4(x.x, 0u) & 0x01010101u;
    const unsigned hi = __vcmpeq4(x.y, 0u) & 0x01010101u;
    return ((lo | lo >> 7 | lo >> 14 | lo >> 21) & 0xfu) |
           ((hi | hi >> 7 | hi >> 14 | hi >> 21) & 0xfu) << 4;
}

__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const __grid_constant__ CompactArgs a) {
    __shared__ long long before[kCompactThreads / 32];
    __shared__ long long unresolved;
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    if (tid == 0) CSTAMP(0, 0);
    // Thread tid's run: the R consecutive words from tid * R, its first
    // kCachedWords held in registers; every load in flight before the
    // count.
    const long long words = (a.n + kFlagsPerWord - 1) / kFlagsPerWord;
    const long long R = (words + kCompactThreads - 1) / kCompactThreads;
    const long long first = tid * R;
    const bool vec = (reinterpret_cast<uintptr_t>(a.resolved) & 7) == 0;
    uint2 held[kCachedWords];
#pragma unroll
    for (int r = 0; r < kCachedWords; ++r)
        held[r] = r < R ? flag_word(a.resolved, a.n, first + r, vec)
                        : make_uint2(~0u, ~0u);
    long long mine = 0;
#pragma unroll
    for (int r = 0; r < kCachedWords; ++r) mine += __popc(zero_flags(held[r]));
    for (long long r = kCachedWords; r < R; ++r)
        mine += __popc(zero_flags(flag_word(a.resolved, a.n, first + r, vec)));
    if (tid == 0) CSTAMP(1, mine);

    // The block's exclusive scan of the counts: a warp scan, then one of
    // the 32 warp totals, which also gives the unresolved total.
    long long incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) before[w] = incl;
    __syncthreads();
    if (w == 0) {
        const long long x = before[lane];
        long long sum = x;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const long long y = __shfl_up_sync(kFull, sum, o);
            if (lane >= o) sum += y;
        }
        before[lane] = sum - x;
        if (lane == 31) unresolved = sum;
    }
    __syncthreads();
    const long long n_un = unresolved;
    long long un = before[w] + incl - mine;  // unresolved before the run
    if (tid == 0) {
        CSTAMP(2, n_un);
        *a.overflow = n_un > a.k;
    }

    // Each flag's place in the stable argsort of `resolved`: an
    // unresolved one after the unresolved before it, a resolved one after
    // every unresolved and the resolved before it; the eight of a word
    // each from the word's mask. The places below k are the slice.
    const long long j0 = first * kFlagsPerWord;
    if (un < a.k || n_un + (j0 - un) < a.k) {
        for (long long r = 0; r < R; ++r) {
            uint2 x = held[0];
#pragma unroll
            for (int c = 1; c < kCachedWords; ++c)
                if (r == c) x = held[c];
            if (r >= kCachedWords)
                x = flag_word(a.resolved, a.n, first + r, vec);
            const unsigned z = zero_flags(x);
            const long long jw = j0 + r * kFlagsPerWord;
#pragma unroll
            for (int b = 0; b < kFlagsPerWord; ++b) {
                const long long j = jw + b;
                const long long u = un + __popc(z & ((1u << b) - 1u));
                const long long rank = (z >> b) & 1u ? u : n_un + (j - u);
                if (j < a.n && rank < a.k) a.slots[rank] = j;
            }
            un += __popc(z);
        }
    }
    if (tid == 0) CSTAMP(kCompactStamps - 1, un);
}

int check_device(int want) {
    int dev = -1;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -(int)err;
    return dev == want ? 0 : -(int)cudaErrorInvalidDevice;
}

}  // namespace

// Host side: the C entries.

// The enumeration's statistics and hits of every anchor or slot.
extern "C" int fc2t_classic_k1(const ClassicArgs* a) {
    if (a->n <= 0) return 0;
    const bool ext = a->ext_id != nullptr, stats = a->count != nullptr;
    // The partials and combining modes look up the keys of [lo, hi); a
    // finish of every key and no other shards is the single table's.
    const bool ranged = a->partials != nullptr || a->n_others > 0 ||
                        a->lo != 0 || a->hi != kEveryKey;
    if (a->anchor_len < 1 || a->anchor_len > kMaxAnchor ||
        a->prefix_len < 1 || a->prefix_len >= a->anchor_len ||
        a->anchor_len - a->prefix_len > 8 || a->rows < 1 ||
        stats != (a->first_pos != nullptr) ||
        (ext && (!stats || a->ext == nullptr || a->extras == nullptr ||
                 a->ext_width < 1 || a->ext_width > kMaxExtWidth ||
                 a->ext_rows < 1 ||
                 reinterpret_cast<uintptr_t>(a->extras) % 16 ||
                 reinterpret_cast<uintptr_t>(a->ext) % 8)) ||
        (!ext && a->extras != nullptr) || (stats && a->slots != nullptr) ||
        (ranged && stats) || a->n_others < 0 ||
        a->n_others >= kMaxShards ||
        (a->n_others > 0) != (a->others != nullptr) ||
        reinterpret_cast<uintptr_t>(a->others) % 16 ||
        (a->partials != nullptr && a->n_others > 0) ||
        (a->partials == nullptr && a->aligned == nullptr))
        return -(int)cudaErrorInvalidValue;
    const int err = check_device(a->device);
    if (err) return err;
    const unsigned blocks = (unsigned)((a->n + kWarps - 1) / kWarps);
    const size_t shared =
        ext ? kWarps * warp_smem_words(1 + 3 * a->anchor_len,
                                       2 * a->ext_width) * sizeof(uint32_t)
            : 0;
    const cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
    if (ext) {
        // The carveout, once a device (a racing second call sets it again).
        static bool carved[kMaxDevices];
        if (a->device < 0 || a->device >= kMaxDevices)
            return -(int)cudaErrorInvalidDevice;
        if (!carved[a->device]) {
            const cudaError_t c = cudaFuncSetAttribute(
                classic_kernel<true, false, false>,
                cudaFuncAttributePreferredSharedMemoryCarveout, kCarveout);
            if (c != cudaSuccess) return -(int)c;
            carved[a->device] = true;
        }
        classic_kernel<true, false, false>
            <<<blocks, kThreads, shared, stream>>>(*a);
    } else if (a->partials) {
        classic_kernel<false, true, false>
            <<<blocks, kThreads, 0, stream>>>(*a);
    } else if (ranged) {
        classic_kernel<false, true, true><<<blocks, kThreads, 0, stream>>>(*a);
    } else {
        classic_kernel<false, false, false>
            <<<blocks, kThreads, 0, stream>>>(*a);
    }
    const cudaError_t e = cudaGetLastError();
    return e == cudaSuccess ? 1 : -(int)e;
}

// The fallback slice's anchor indices and the overflow flag.
extern "C" int fc2t_compact(const CompactArgs* a) {
    if (a->n <= 0) return 0;
    if (a->k < 0 || a->k > a->n) return -(int)cudaErrorInvalidValue;
    const int err = check_device(a->device);
    if (err) return err;
    compact_kernel<<<1, kCompactThreads, 0,
                     static_cast<cudaStream_t>(a->stream)>>>(*a);
    const cudaError_t e = cudaGetLastError();
    return e == cudaSuccess ? 1 : -(int)e;
}

#ifdef FC2T_CLASSIC_STAMPS
// Where the next launches record their stage clocks (null: nowhere).
extern "C" int fc2t_classic_stamps(void* stamps) {
    unsigned long long* p = static_cast<unsigned long long*>(stamps);
    const cudaError_t err = cudaMemcpyToSymbol(fc2t_cstamps, &p, sizeof p);
    return err == cudaSuccess ? 0 : -(int)err;
}
#endif
