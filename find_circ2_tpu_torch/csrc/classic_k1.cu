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
// The plain versions are about 270 eager kernels a detect batch's
// fallback slice and 546 an explore chunk's K1.
//
// What bounds it on this card: bytes. Each anchor reads 61 x 2 random
// 32-byte bucket rows (about 3.9 KB); with the extras also 61 x 2 ext_id
// rows of 8 bytes and up to 61 ext rows of 120 bytes, and it writes 122
// counts, 122 first positions and 122 x 15 extra positions (about 16 KB).
// Its arithmetic, a few hundred 32-bit operations a variant, is less.
// chip_smoke.py computes the bound from each run's data. Each row is a
// random access into a table larger than the L2, so the design:
//
//  - One warp an anchor, four a block. Lane l takes the canonical
//    variants l and l + 32 (V = 61 <= 64) in enumerate_variants' order,
//    builds each key from the anchor's base keys and the substitution's
//    delta, swaps to the canonical key, hashes both salts and issues all
//    its row loads (16 bytes at a time, 8 for ext_id) before it uses any
//    of them: eight table loads and four ext_id loads in flight a lane.
//  - Sums and minima over the warp with __reduce_add_sync and
//    __reduce_min_sync; lane 0 takes the exact slots 0 and V and writes
//    the hit fields.
//  - With the extras, each lane loads its variants' ext rows (the second,
//    dependent round trip, 8 bytes at a time) into shared memory, so that
//    the warp writes each strand's [32, 15] int64 block of `extras`
//    contiguously.
//  - The slice: one block scans `resolved` in chunks of 1024 with a
//    running carry (any batch size), writes the slice's anchor indices in
//    the stable argsort's order (the unresolved first, then the resolved,
//    each in index order) and the 0-d overflow flag that detect's core
//    reads on the device; then the enumeration in "slot" mode reads
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

// The arguments of one enumeration, packed by ops/anchor_align.py into
// one buffer. Three modes: hits only (count == nullptr, slots ==
// nullptr); the per-slot statistics too (count and first_pos, and with
// ext_id the extras); and the fallback slice (slots != nullptr): slot s
// enumerates anchors[slots[s]] and writes its hits at slots[s].
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
};
static_assert(sizeof(ClassicArgs) == 184, "layout packed by ops/anchor_align");

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

namespace {

using fc2t::holds;
using fc2t::kCntBits;
using fc2t::kCntMask;
using fc2t::kLargeMm;
using fc2t::kLargePos;
using fc2t::kSlots;
using fc2t::mix_hash;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                  // anchors a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPerLane = 2;                // variants a lane: V <= 64
constexpr int kMaxAnchor = 21;             // V = 1 + 3a <= 32 * kPerLane
constexpr int kMaxExtWidth = 15;           // K - 1, explore's K <= 16
constexpr int kCompactThreads = 1024;

// The place value of anchor digit j in each key (_weights): the forward
// (prefix, suffix) key and the reverse complement's.
struct Weights {
    long long wp, ws, wpr, wsr;
};

__device__ __forceinline__ Weights weights(int j, int al, int pk) {
    const int sk = al - pk;
    return {j < pk ? 1ll << (2 * (pk - 1 - j)) : 0,
            j >= pk ? 1ll << (2 * (al - 1 - j)) : 0,
            j >= al - pk ? 1ll << (2 * (j - (al - pk))) : 0,
            j < sk ? 1ll << (2 * j) : 0};
}

__global__ void __launch_bounds__(kThreads)
classic_kernel(const __grid_constant__ ClassicArgs a) {
    // With the extras: a warp's 32 ext rows.
    extern __shared__ uint32_t stage_all[];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int s = blockIdx.x * kWarps + w;
    if (s >= a.n) return;  // the whole warp
    const long long anchor = a.slots ? a.slots[s] : s;
    const int al = a.anchor_len, pk = a.prefix_len, V = 1 + 3 * al;
    const uint8_t* anc = a.anchors + anchor * al;

    // enumerate_variants: lane j holds code j; the base keys on the codes
    // with those >= 4 zeroed; `clean` over the whole anchor.
    const int code = lane < al ? anc[lane] : 0;
    const bool clean = __all_sync(kFull, lane >= al || code < 4);
    const int q = code < 4 ? code : 0;
    long long p12 = 0, s8 = 0, p12r = 0, s8r = 0;
    for (int j = 0; j < al; ++j) {
        const long long qj = __shfl_sync(kFull, q, j);
        const Weights wt = weights(j, al, pk);
        p12 += qj * wt.wp;
        s8 += qj * wt.ws;
        p12r += (3 - qj) * wt.wpr;
        s8r += (3 - qj) * wt.wsr;
    }

    // Each of the lane's variants: its canonical key, both buckets, and
    // every row load in flight before any is used.
    const uint32_t n_buckets = (uint32_t)a.meta[2];
    const uint32_t salt[2] = {(uint32_t)a.meta[0], (uint32_t)a.meta[1]};
    const bool want_ext = a.ext_id != nullptr;
    bool act[kPerLane], swp[kPerLane];
    long long cp[kPerLane];
    uint32_t cs[kPerLane];
    int4 g[kPerLane][2][kSlots];
    int2 e[kPerLane][2];
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
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            const uint32_t h =
                mix_hash((uint32_t)cp[t], cs[t], salt[p]) % n_buckets;
            const bool in = act[t] && (long long)h < a.rows;
            const int4* tr = reinterpret_cast<const int4*>(a.table) +
                             (size_t)h * kSlots;
#pragma unroll
            for (int u = 0; u < kSlots; ++u)
                g[t][p][u] = in ? __ldg(tr + u) : make_int4(-1, 0, 0, 0);
            e[t][p] = in && want_ext
                          ? __ldg(reinterpret_cast<const int2*>(a.ext_id) + h)
                          : make_int2(0, 0);
        }
    }

    // candidate_stats: both probes folded (counts and ext row ids add,
    // positions take the least), each strand slot swapped into '+' / '-',
    // the `valid` mask, then the guard on each slot.
    int cnt_p[kPerLane], cnt_m[kPerLane];
    uint32_t pos_p[kPerLane], pos_m[kPerLane];
    long long rid[kPerLane];
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
        int cf = 0, cr = 0;
        uint32_t pf = kLargePos, pr = kLargePos;
        long long r_id = 0;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
            for (int u = 0; u < kSlots; ++u) {
                const int4 r = g[t][p][u];
                if (!holds(r, cp[t], cs[t])) continue;
                cf += (int)(((unsigned)r.y >> 16) & kCntMask);
                cr += (int)(((unsigned)r.y >> (16 + kCntBits)) & kCntMask);
                pf = min(pf, (uint32_t)r.z);
                pr = min(pr, (uint32_t)r.w);
                r_id += u == 0 ? e[t][p].x : e[t][p].y;
            }
        }
        int cp_ = swp[t] ? cr : cf, cm_ = swp[t] ? cf : cr;
        if (!clean) cp_ = cm_ = 0;
        cnt_p[t] = cp_ > a.max_bucket ? 0 : cp_;
        cnt_m[t] = cm_ > a.max_bucket ? 0 : cm_;
        pos_p[t] = swp[t] ? pr : pf;
        pos_m[t] = swp[t] ? pf : pr;
        rid[t] = r_id;
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
    if (lane == 0) {
        // _hits.
        const int second_mm = n_best > 1 ? m0
                              : (m0 == 0 && total > n_exact) ? 1
                                                             : al + 1;
        const int q10 = 10 * (second_mm - m0);
        a.aligned[anchor] = m0 <= a.max_anchor_mm;
        a.pos[anchor] = (int64_t)best;
        a.strand[anchor] = strand;
        a.mm[anchor] = m0;
        a.n_best[anchor] = n_best;
        a.second_mm[anchor] = second_mm;
        a.qual[anchor] = n_best > 1 ? 0 : (q10 < 40 ? q10 : 40);
    }

    if (!a.extras) return;
    // The extras: each variant's ext row (row id 0 is the all-LARGE
    // dummy row; an id at or past ext_rows reads LARGE_POS), its forward
    // half to the '+' slot and its reverse half to the '-' slot, the two
    // exchanged when the variant swapped. The rows of the warp's 32
    // variants are staged in shared memory, then the warp writes each
    // strand's [32, K - 1] block of `extras` contiguously.
    const int K1 = a.ext_width, W = 2 * K1;
    uint32_t* stage = stage_all + (size_t)w * 32 * W;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
        const int nv = min(32, V - 32 * t);
        if (nv <= 0) break;  // the same for every lane
        const bool in = act[t] && rid[t] >= 0 && rid[t] < a.ext_rows;
        const int2* xr = reinterpret_cast<const int2*>(a.ext) +
                         (in ? (size_t)rid[t] * K1 : 0);
        int2 x[kMaxExtWidth];
#pragma unroll
        for (int c = 0; c < kMaxExtWidth; ++c)
            x[c] = in && c < K1 ? __ldg(xr + c) : make_int2(-1, -1);
        const unsigned swaps = __ballot_sync(kFull, swp[t]);
        __syncwarp();  // the last round's reads of the stage are done
#pragma unroll
        for (int c = 0; c < kMaxExtWidth; ++c) {
            if (c >= K1) break;
            stage[lane * W + 2 * c] = (uint32_t)x[c].x;
            stage[lane * W + 2 * c + 1] = (uint32_t)x[c].y;
        }
        __syncwarp();
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            int64_t* dst = a.extras +
                           ((size_t)s * 2 * V + half * V + 32 * t) * K1;
            for (int m = lane; m < nv * K1; m += 32) {
                const int l = m / K1, k = m - l * K1;
                const int off = (half == 1) != ((swaps >> l) & 1u) ? K1 : 0;
                dst[m] = (int64_t)stage[l * W + off + k];
            }
        }
    }
}

__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const __grid_constant__ CompactArgs a) {
    __shared__ int sums[kCompactThreads / 32];
    __shared__ long long unresolved;
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    // The unresolved anchors of the batch.
    int mine = 0;
    for (long long j = tid; j < a.n; j += kCompactThreads)
        mine += a.resolved[j] == 0;
    mine = (int)__reduce_add_sync(kFull, (unsigned)mine);
    if (lane == 0) sums[w] = mine;
    __syncthreads();
    if (w == 0) {
        const int c = (int)__reduce_add_sync(
            kFull, (unsigned)(lane < kCompactThreads / 32 ? sums[lane] : 0));
        if (lane == 0) unresolved = c;
    }
    __syncthreads();
    const long long n_un = unresolved;
    if (tid == 0) *a.overflow = n_un > a.k;
    // Each anchor's place in the stable argsort of `resolved`: an
    // unresolved one after the unresolved before it, a resolved one after
    // every unresolved and the resolved before it. A chunk of 1024 at a
    // time, carrying the unresolved count of the chunks before.
    long long carry = 0;
    for (long long base = 0; base < a.n; base += kCompactThreads) {
        const long long j = base + tid;
        const bool un = j < a.n && a.resolved[j] == 0;
        const unsigned ballot = __ballot_sync(kFull, un);
        __syncthreads();  // the last chunk's sums are read
        if (lane == 0) sums[w] = __popc(ballot);
        __syncthreads();
        int before = __popc(ballot & ((1u << lane) - 1u)), chunk = 0;
        for (int x = 0; x < kCompactThreads / 32; ++x) {
            const int c = sums[x];
            before += x < w ? c : 0;
            chunk += c;
        }
        if (j < a.n) {
            const long long un_before = carry + before;
            const long long rank = un ? un_before : n_un + (j - un_before);
            if (rank < a.k) a.slots[rank] = j;
        }
        carry += chunk;
    }
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
    if (a->anchor_len < 1 || a->anchor_len > kMaxAnchor ||
        a->prefix_len < 1 || a->prefix_len >= a->anchor_len ||
        a->anchor_len - a->prefix_len > 8 || a->rows < 1 ||
        stats != (a->first_pos != nullptr) ||
        (ext && (!stats || a->ext == nullptr || a->extras == nullptr ||
                 a->ext_width < 1 || a->ext_width > kMaxExtWidth ||
                 a->ext_rows < 1)) ||
        (!ext && a->extras != nullptr) || (stats && a->slots != nullptr))
        return -(int)cudaErrorInvalidValue;
    const int err = check_device(a->device);
    if (err) return err;
    const unsigned blocks = (unsigned)((a->n + kWarps - 1) / kWarps);
    const size_t shared =
        ext ? (size_t)kWarps * 32 * 2 * a->ext_width * sizeof(uint32_t) : 0;
    classic_kernel<<<blocks, kThreads, shared,
                     static_cast<cudaStream_t>(a->stream)>>>(*a);
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
