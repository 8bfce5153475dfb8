// §2b multi-hit pair exploration (K-g) of one chunk of routed reads: one
// thread block per read, one launch per chunk.
//
// Replaces, after K1 (candidate_stats, finalize_hits), everything of the
// plain explore_batch_packed in find_circ2_tpu_torch/ops/explore.py:
// merged_candidates for both anchors, _candidate_side for both,
// explore_core and ops/detect._pack. The reference computes the same
// as XLA programs, not Pallas (find_circ2_tpu/ops/explore.py:61
// merged_candidates, :101 _candidate_side, :147 explore_core), with the
// prefix sums as a bf16 triangular-ones matmul and an int32
// [B, K, K, Lp+1] split grid in device memory. The plain PyTorch version
// (explore_pairs_ref) is about a thousand eager kernels a 1024-read chunk
// over int32 copies of that grid, 168.8 MB each at K = 16, Lp = 160.
//
// What bounds it on this card. The work is a few MB of bytes (the reads,
// K1's count rows, the first_pos/extras lanes at each anchor's best
// mismatch level, the 2K candidates' window words, the [B, 14] rows) and
// int32 arithmetic over (viable pair, split): a few dozen of a read's
// K x K pairs can pair and walk Lp - 2a + 1 splits at most. At the
// H100's 3.35 TB/s and 67 T/s 32-bit rate both bounds are a few
// microseconds a 1024-read chunk (chip_smoke.py computes them from each
// run's data). Neither is what the kernel meets. A chunk is 1024 blocks,
// under two waves on 132 SMs, so the time is about two blocks' critical
// paths: three dependent round trips to device memory (K1's count rows,
// then the lanes they select, then the windows those lanes name), each
// about a microsecond on the card, and the block's own instructions
// between its barriers. The design shortens that path (stage_cycles in
// ops/explore.py measures each stage through the FC2T_EXPLORE_STAMPS
// build):
//
//  1. Prologue: everything that does not depend on the candidates (both
//     anchors' count rows, mm_v, the hit fields the epilogue reads, small
//     chromosome tables) goes to shared memory by cp.async, issued at
//     once with one commit and one wait; the read by plain loads issued
//     before that wait.
//  2. Merge without block rounds: each slot's lanes at the best level go
//     to shared memory; then the four lists (2 anchors x 2 strands) go
//     to four warp pairs at once. Each lane loads its 16 entries of a
//     list straight into registers (all its shared loads, then all its
//     predicated global loads, in flight together) and sorts them with a
//     register bitonic network; K rounds of a warp minimum
//     (__reduce_min_sync, the owner by __ballot_sync) take the warp's K
//     smallest, the owner shifting its next entry up; no barrier. One
//     barrier, then each of the at most 2K survivors of a list is ranked
//     against the other warp's (kRankMax). Only values leave the merge,
//     so duplicates stay as `sort` keeps them.
//  3. Windows in one round trip: all 2K candidates' nibble words (start
//     clamped as _candidate_side) by cp.async, one commit and one wait,
//     with each candidate's chromosome found once and the read and its
//     reverse complement packed into nibble words meanwhile. Then 8
//     lanes per candidate, each a run of splits, 8 a step: mismatches and
//     dinucleotide flags by word operations on the nibbles, a prefix scan
//     over the 8 lanes, one int16 a split stored 16 bytes at a time: its
//     role's flags plus 4 x its prefix mismatch count (left piece) or
//     minus it (right piece; the pair adds the right piece's total).
//  4. Pairs: the K x K pairs are flagged viable (valid lanes, one strand
//     and chromosome, linear or circular) by ballots and compacted; each
//     viable pair gets g lanes (32 for up to 8 pairs, down to 1 for more
//     than 128), which take splits k = lo + sub, lo + sub + g, ... and
//     reduce by shuffles: the minimum packed split key (score, !canon+,
//     !canon-, k) and the minimum score with its count. The split grid
//     never exists.
//  5. The frozen pair tie-break (edits, !c+, !c-, pA, pB, s), then the
//     first pair in row-major order, is one lexicographic reduction of a
//     96-bit key over the viable pairs by one warp; the rescue's `alt`
//     one more pass over them. The same warp writes the row.
//
// Not used, and why: tensor cores (wgmma, mma.sync): the function has no
// product. TMA: the loads are data-dependent gathers of 4 to 88 bytes.
// Thread block clusters: blocks share nothing.
// Position arithmetic is uint32 and wraps where the plain code masks with
// & 0xFFFFFFFF.
//
// Plain C interface for ctypes: one packed argument buffer (ExploreArgs).
// The entry returns the kernels it launched (1, or 0 for an empty chunk),
// or minus a CUDA error.

#include <cstddef>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "nibbles.cuh"

// One anchor's K1 outputs, rows of [B, ...] int tensors.
struct ExploreAnchor {
    const int32_t* count;      // [B, 2V] candidate_stats
    const int64_t* first_pos;  // [B, 2V], uint32 values
    const int64_t* extras;     // [B, 2V, K-1], uint32 values
    const int64_t* pos;        // [B] finalize_hits, uint32 values
    const int32_t* strand;     // [B]
    const uint8_t* aligned;    // [B] bool
    const int32_t* mm;         // [B]
    const int32_t* n_best;     // [B]
    const int32_t* qual;       // [B]
};

// The arguments of one call, packed by ops/explore.py into one buffer.
struct ExploreArgs {
    const int32_t* words;          // nibble-packed genome (ops/packed.py)
    const int64_t* chrom_offsets;  // [n_chroms], ascending
    const uint8_t* reads;          // [B, Lp] codes
    const int32_t* lens;           // [B]
    const int32_t* mm_v;           // [2V] per-slot mismatch level
    int32_t* out;                  // [B, 14], PACK_FIELDS order
    ExploreAnchor anchor[2];       // anchors A and B
    void* stream;
    long long nbases;              // >= Lp + 2
    int B, Lp, V, K, n_chroms, anchor_len, prefilter_mm, pair_rescue,
        prefilter, device;
};
static_assert(sizeof(ExploreArgs) == 248, "layout packed by ops/explore");

// The block's shared memory, carved by Layout below.
extern __shared__ __align__(16) unsigned char fc2t_explore_smem[];

// Built with FC2T_EXPLORE_STAMPS (ops/explore.stage_cycles), thread 0
// records its SM clock at the start, at the barrier that ends each stage
// and before the row: kStamps values a block into fc2t_stamps[B,
// kStamps]. Without it, STAMP is nothing.
constexpr int kStamps = 9;
#ifdef FC2T_EXPLORE_STAMPS
__device__ unsigned long long* fc2t_stamps = nullptr;
#define STAMP(s)                                                          \
    do {                                                                  \
        if (threadIdx.x == 0 && fc2t_stamps)                              \
            fc2t_stamps[(size_t)blockIdx.x * kStamps + (s)] = clock64();  \
    } while (0)
#else
#define STAMP(s) \
    do {         \
    } while (0)
#endif

namespace {

using fc2t::comp;
using fc2t::mismatches;
using fc2t::nibbles;
using fc2t::same;
using fc2t::upper;
using fc2t::window_base;
using fc2t::window_start;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;     // 4 lists x 2 halves
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 16;                 // K * K pairs <= kThreads
constexpr int kLaneEntries = 16;          // list entries a lane holds
constexpr int kMaxListLanes = 1024;       // V * K <= 2 * 32 * kLaneEntries
constexpr int kRankMax = 32;              // survivors of a list: 2 x kMaxK
constexpr int kChromShared = 256;         // chromosome tables kept in smem
constexpr uint32_t kLargePos = 0xffffffffu;
constexpr int kBig = 1 << 20;             // ops/explore.py BIG
constexpr int kNoSplit = 1 << 30;         // the split key's fill
constexpr int kPackFields = 14;
// config.py's codes.
constexpr int kA = 0, kC = 1, kG = 2, kT = 3, kRpad = 6;
constexpr int kJunction = 0, kPrefiltered = 3, kUnalignedA = 4,
              kUnalignedB = 5, kDiffStrand = 6, kDiffChrom = 7,
              kAnchorOverlap = 8, kNoJunction = 9;
constexpr int kLinear = 0, kCircular = 1, kSenseMinus = 1;

// The hit fields of both anchors in shared memory (int32 each).
enum Hit { hStrand, hMm, hNbest, hQual, hAligned, kHitFields };

// Byte offsets of the block's shared memory (all dynamic), from Lp, K, V
// and the chromosomes kept in shared memory. 8-byte arrays first.
struct Layout {
    int stride;  // int16 per candidate row of `rows`, a multiple of 8
    int nw;      // window words per candidate, one spare past any read
    int nq;      // nibble words of the read (and of its complement)
    size_t pkey_hi, pkey_lo, surv, offs, hpos, rows, words, cnt, mmv, cpos,
        cs0, cstr, cch, ctot, pstart, pend, pkn, hit, survn, pmask, misc,
        qw, plist, read, total;
};

__host__ __device__ inline Layout layout(int Lp, int K, int V,
                                         int n_offs) {
    Layout L;
    L.stride = (Lp + 8) & ~7;
    L.nw = (Lp + 16) / 8 + 2;
    L.nq = (Lp + 8) / 8 + 1;
    const size_t P = (size_t)K * K, C = (size_t)2 * K;
    size_t o = 0;
    L.pkey_hi = o;  o += P * 8;
    L.pkey_lo = o;  o += P * 8;
    L.surv = o;     o += (size_t)kWarps * K * 4;
    L.offs = o;     o += (size_t)n_offs * 8;
    L.hpos = o;     o += 2 * 8;
    o = (o + 15) & ~(size_t)15;
    L.rows = o;     o += C * L.stride * 2;
    L.words = o;    o += C * L.nw * 4;
    L.cnt = o;      o += (size_t)2 * 2 * V * 4;
    L.mmv = o;      o += (size_t)2 * V * 4;
    L.cpos = o;     o += C * 4;
    L.cs0 = o;      o += C * 4;
    L.cstr = o;     o += C * 4;   // strand, or -1: an invalid lane
    L.cch = o;      o += C * 4;
    L.ctot = o;     o += C * 4;   // mismatches over the whole read
    L.pstart = o;   o += P * 4;
    L.pend = o;     o += P * 4;
    L.pkn = o;      o += P * 4;
    L.hit = o;      o += 2 * kHitFields * 4;
    L.survn = o;    o += kWarps * 4;
    L.pmask = o;    o += kWarps * 4;
    L.misc = o;     o += 4 * 4;   // [0]: the §6 prefilter flag
    L.qw = o;       o += (size_t)2 * L.nq * 4;  // read, reverse complement
    L.plist = o;    o += P;       // viable pairs, row-major index
    L.read = o;     o += Lp;
    L.total = (o + 15) & ~(size_t)15;
    return L;
}

// 4- or 8-byte asynchronous copy, global to shared.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           size_t bytes) {
    __pipeline_memcpy_async(dst, src, bytes);
}

__global__ void __launch_bounds__(kThreads)
explore_kernel(const __grid_constant__ ExploreArgs a, const int n_offs) {
    const int b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int Lp = a.Lp, K = a.K, V = a.V, al = a.anchor_len;
    const int V2 = 2 * V, K2 = 2 * K, KK = K * K;
    const uint32_t ua = (uint32_t)al;
    const Layout L = layout(Lp, K, V, n_offs);
    unsigned char* smem = fc2t_explore_smem;
    auto* pkey_hi = reinterpret_cast<unsigned long long*>(smem + L.pkey_hi);
    auto* pkey_lo = reinterpret_cast<unsigned long long*>(smem + L.pkey_lo);
    auto* surv = reinterpret_cast<uint32_t*>(smem + L.surv);
    auto* offs_s = reinterpret_cast<int64_t*>(smem + L.offs);
    auto* hpos = reinterpret_cast<int64_t*>(smem + L.hpos);
    auto* rows = reinterpret_cast<int16_t*>(smem + L.rows);
    auto* wsm = reinterpret_cast<uint32_t*>(smem + L.words);
    auto* cnt = reinterpret_cast<int*>(smem + L.cnt);
    auto* mmv = reinterpret_cast<int*>(smem + L.mmv);
    auto* cpos = reinterpret_cast<uint32_t*>(smem + L.cpos);
    auto* cs0 = reinterpret_cast<uint32_t*>(smem + L.cs0);
    auto* cstr = reinterpret_cast<int*>(smem + L.cstr);
    auto* cch = reinterpret_cast<int*>(smem + L.cch);
    auto* ctot = reinterpret_cast<int*>(smem + L.ctot);
    auto* pstart = reinterpret_cast<uint32_t*>(smem + L.pstart);
    auto* pend = reinterpret_cast<uint32_t*>(smem + L.pend);
    auto* pkn = reinterpret_cast<uint32_t*>(smem + L.pkn);
    auto* hit = reinterpret_cast<int*>(smem + L.hit);
    auto* survn = reinterpret_cast<int*>(smem + L.survn);
    auto* pmask = reinterpret_cast<unsigned*>(smem + L.pmask);
    auto* misc = reinterpret_cast<int*>(smem + L.misc);
    uint8_t* plist = smem + L.plist;
    uint8_t* R = smem + L.read;
    auto* qw = reinterpret_cast<uint32_t*>(smem + L.qw);
    const int64_t* offs = n_offs ? offs_s : a.chrom_offsets;
    const int nw = L.nw, nq = L.nq;
    STAMP(0);

    // --- 1. prologue: every load that does not depend on the candidates,
    // one commit, one wait.
    const size_t row2 = (size_t)b * V2;
    for (int t = tid; t < 3 * V2; t += kThreads) {
        if (t < 2 * V2) {
            const int x = t >= V2;
            copy_async(cnt + t, a.anchor[x].count + row2 + (t - x * V2), 4);
        } else {
            copy_async(mmv + t - 2 * V2, a.mm_v + t - 2 * V2, 4);
        }
    }
    for (int t = tid; t < n_offs; t += kThreads)
        copy_async(offs_s + t, a.chrom_offsets + t, 8);
    if (tid < 2) {
        copy_async(hpos + tid, a.anchor[tid].pos + b, 8);
    } else if (tid < 10) {
        const int x = (tid - 2) >> 2, f = (tid - 2) & 3;
        const ExploreAnchor& an = a.anchor[x];
        const int32_t* src = f == hStrand ? an.strand
                             : f == hMm   ? an.mm
                             : f == hNbest ? an.n_best
                                           : an.qual;
        copy_async(hit + x * kHitFields + f, src + b, 4);
    }
    __pipeline_commit();
    const int len = a.lens[b];
    const uint8_t* read = a.reads + (size_t)b * Lp;
    for (int p = tid; p < Lp; p += kThreads) R[p] = read[p];
    if (tid >= 10 && tid < 12)
        hit[(tid - 10) * kHitFields + hAligned] = a.anchor[tid - 10].aligned[b];
    if (tid == 12) misc[0] = 0;
    __pipeline_wait_prior(0);
    __syncthreads();
    STAMP(1);

    // Each slot's lanes at its anchor's best mismatch level: min(count, K),
    // else none.
    int* lanes = cnt;  // in place: [2][2V]
    for (int e = tid; e < 2 * V2; e += kThreads) {
        const int x = e >= V2;
        const int c = cnt[e];
        lanes[e] = c > 0 && mmv[e - x * V2] == hit[x * kHitFields + hMm]
                       ? (c < K ? c : K)
                       : 0;
    }
    __syncthreads();

    // --- 2. merged_candidates: warp pair `list` (anchor x, strand st)
    // holds its list's lanes at the best level, half h each, in
    // registers; K rounds of a warp minimum over (position, index).
    {
        const int list = warp >> 1, h = warp & 1;
        const int x = list >> 1, st = list & 1;
        const ExploreAnchor& an = a.anchor[x];
        const size_t srow = row2 + (size_t)st * V;
        const int64_t* fp = an.first_pos + srow;
        const int64_t* ex = an.extras + srow * (K - 1);
        const int VK = V * K;
        // q / K by a float product: exact, as q < 2^10 and K <= 16 leave
        // (q + 0.5) / K at least 1 / 32 from an integer.
        const float inv_k = __frcp_rn((float)K);
        // All of a lane's shared loads first, then one predicated global
        // load an entry with no branch between them, so all of them are
        // in flight together.
        const int* nrow = lanes + x * V2 + st * V;
        uint32_t val[kLaneEntries];
        int nl[kLaneEntries];
#pragma unroll
        for (int u = 0; u < kLaneEntries; ++u) {
            const int q = (2 * u + h) * 32 + lane;
            const int sl = (int)(((float)q + 0.5f) * inv_k);
            nl[u] = q < VK ? nrow[sl < V ? sl : V - 1] : 0;
        }
#pragma unroll
        for (int u = 0; u < kLaneEntries; ++u) {
            const int q = (2 * u + h) * 32 + lane;
            const int sl = (int)(((float)q + 0.5f) * inv_k);
            const int l = q - sl * K;
            const int64_t* base = l == 0 ? fp : ex;
            const int off = l == 0 ? sl : sl * (K - 1) + l - 1;
            int64_t raw = kLargePos;
            if (l < nl[u]) raw = base[off];
            val[u] = (uint32_t)raw;
        }
        // Each lane sorts its entries (a register bitonic network); then
        // K rounds take the warp's smallest head, whose lane shifts its
        // next entry up. Only values leave the merge, so equal positions
        // are all kept, as `sort` keeps duplicates.
#pragma unroll
        for (int k = 2; k <= kLaneEntries; k <<= 1)
#pragma unroll
            for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
                for (int i = 0; i < kLaneEntries; ++i) {
                    const int l = i ^ j;
                    if (l > i) {
                        const uint32_t lo = min(val[i], val[l]);
                        const uint32_t hi = max(val[i], val[l]);
                        val[i] = (i & k) == 0 ? lo : hi;
                        val[l] = (i & k) == 0 ? hi : lo;
                    }
                }
        int r = 0;
        for (; r < K; ++r) {
            const uint32_t mv = __reduce_min_sync(kFull, val[0]);
            if (mv == kLargePos) break;
            const unsigned owner =
                __ffs(__ballot_sync(kFull, val[0] == mv)) - 1;
            if (lane == 0) surv[warp * K + r] = mv;
            if ((unsigned)lane == owner) {
#pragma unroll
                for (int u = 0; u + 1 < kLaneEntries; ++u) val[u] = val[u + 1];
                val[kLaneEntries - 1] = kLargePos;
            }
        }
        if (lane == 0) survn[warp] = r;
    }
    __syncthreads();
    STAMP(2);

    // Rank each survivor against the other half of its list (equal
    // positions: half 0 first); the K smallest per strand, '+' entries
    // before '-', capped at K.
    if (tid < kWarps * K) {
        const int w = tid / K, r = tid - w * K;
        if (r < survn[w]) {
            const uint32_t v = surv[w * K + r];
            const int o = w ^ 1;
            int rank = r;
            for (int e = 0; e < survn[o]; ++e)
                rank += o < w ? surv[o * K + e] <= v : surv[o * K + e] < v;
            const int x = w >> 2, st = (w >> 1) & 1;
            const int n0 = survn[4 * x] + survn[4 * x + 1];
            const int t = st == 0 ? rank : (n0 < K ? n0 : K) + rank;
            if (rank < K && t < K) {
                cpos[x * K + t] = v;
                cstr[x * K + t] = st;
            }
        }
    } else if (tid < kWarps * K + K2) {
        const int c = tid - kWarps * K, x = c / K;
        const int n0 = survn[4 * x] + survn[4 * x + 1];
        const int n1 = survn[4 * x + 2] + survn[4 * x + 3];
        const int n = (n0 < K ? n0 : K) + (n1 < K ? n1 : K);
        if (c - x * K >= n) {
            cpos[c] = kLargePos;
            cstr[c] = -1;
        }
    }
    __syncthreads();
    STAMP(3);

    // --- 3. windows: every valid candidate's words in one round trip;
    // meanwhile its chromosome and the reverse complement.
    const uint32_t max_start = (uint32_t)(a.nbases - (Lp + 2));
    for (int e = tid; e < K2 * nw; e += kThreads) {
        const int c = e / nw, k = e - c * nw;
        const int st = cstr[c];
        if (st < 0) continue;
        const uint32_t s0 = window_start(c < K ? st == 0 : st == 1, cpos[c],
                                         ua, len, max_start);
        const uint32_t w0 = s0 >> 3;
        if (w0 + k <= (s0 + Lp + 1) >> 3)
            copy_async(wsm + c * nw + k, a.words + w0 + k, 4);
    }
    __pipeline_commit();
    if (tid < K2 && cstr[tid] >= 0) {
        const int st = cstr[tid];
        cs0[tid] = window_start(tid < K ? st == 0 : st == 1, cpos[tid], ua,
                                len, max_start);
        cch[tid] = upper(offs, a.n_chroms, cpos[tid]) - 1;
    }
    // The read and its reverse complement (RPAD past len) as nibble
    // words, base p at bits 4 (p % 8) of word p / 8.
    for (int t = tid; t < 2 * nq; t += kThreads) {
        const bool rc = t >= nq;
        const int i = rc ? t - nq : t;
        uint32_t word = 0;
        for (int j = 0; j < 8; ++j) {
            const int p = 8 * i + j;
            const int src = len - 1 - p < Lp - 1 ? len - 1 - p : Lp - 1;
            const int code = rc ? (p < len ? comp(R[src]) : kRpad)
                                : (p < Lp ? R[p] : kRpad);
            word |= (uint32_t)code << (4 * j);
        }
        qw[t] = word;
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    STAMP(4);

    // The K x K pairs that can pair (valid lanes, one strand and
    // chromosome, linear or circular), one ballot mask a warp.
    bool viable = false;
    if (tid < KK) {
        const int i = tid / K, j = tid - i * K;
        const int si = cstr[i];
        if (si >= 0 && si == cstr[K + j] && cch[i] == cch[K + j]) {
            // Strand canonicalization [FROZEN] SPEC §3: '-' pairs swap
            // roles.
            const uint32_t pA = si == 0 ? cpos[i] : cpos[K + j];
            const uint32_t pB = si == 0 ? cpos[K + j] : cpos[i];
            viable = pA + ua <= pB || pB + ua <= pA;
        }
    }
    {
        const unsigned m = __ballot_sync(kFull, viable);
        if (lane == 0) pmask[warp] = m;
    }

    // _candidate_side: kPartLanes lanes a candidate, each a run of
    // consecutive splits, 8 a step as nibble words: one pass counts the
    // run's mismatches, a scan over the candidate's lanes gives each run
    // its prefix, a second pass writes the row, 16 bytes a step. A
    // candidate's row keeps, per split k, its role's two dinucleotide
    // flags plus 4 x its prefix mismatch count pf(k) (left piece) or
    // minus it (right piece, whose suffix count is then ctot + row >> 2).
    {
        constexpr int kPartLanes = kThreads / (2 * kMaxK);
        const int c = tid / kPartLanes, part = tid - c * kPartLanes;
        const int st = c < K2 ? cstr[c] : -1;
        const bool left = c < K ? st == 0 : st == 1;
        const uint32_t s0 = st >= 0 ? cs0[c] : 0;
        const uint32_t* w = wsm + c * nw;
        const uint32_t* q = qw + (st == 0 ? 0 : nq);
        const int off = left ? 0 : 2;
        const int run = 8 * ((Lp + 64) / 64);  // splits 0..Lp in 8 runs
        const int k0 = part * run;
        const int k1 = st < 0 ? k0 : (k0 + run < Lp + 1 ? k0 + run : Lp + 1);
        const int lim = len < Lp ? len : Lp;   // mismatches in [0, lim)
        int n = 0;
        for (int k = k0; k < k1; k += 8)
            n += __popc(mismatches(q[k >> 3], nibbles(w, s0, k + off),
                                   lim - k));
        int pf = n;  // inclusive scan over the candidate's lanes
        for (int d = 1; d < kPartLanes; d <<= 1) {
            const int y = __shfl_up_sync(kFull, pf, d);
            if (part >= d) pf += y;
        }
        const int total = __shfl_sync(kFull, pf, kPartLanes - 1, kPartLanes);
        pf -= n;
        int16_t* row = rows + c * L.stride;
        for (int k = k0; k < k1; k += 8) {
            const uint32_t mis =
                mismatches(q[k >> 3], nibbles(w, s0, k + off), lim - k);
            const uint32_t w0 = nibbles(w, s0, k), w1 = nibbles(w, s0, k + 1);
            const uint32_t f =
                left ? (same(w0, kG) & same(w1, kT)) << 1 |
                           (same(w0, kC) & same(w1, kT))
                     : (same(w0, kA) & same(w1, kG)) << 1 |
                           (same(w0, kA) & same(w1, kC));
            uint32_t out[4];
#pragma unroll
            for (int j = 0; j < 8; j += 2) {
                const int p0 = pf + __popc(mis & ((1u << (4 * j)) - 1u));
                const int p1 = pf + __popc(mis & ((1u << (4 * j + 4)) - 1u));
                const int f0 = (f >> (4 * j)) & 3, f1 = (f >> (4 * j + 4)) & 3;
                const int v0 = left ? p0 * 4 + f0 : f0 - p0 * 4;
                const int v1 = left ? p1 * 4 + f1 : f1 - p1 * 4;
                out[j >> 1] = (uint32_t)(uint16_t)v0 | (uint32_t)v1 << 16;
            }
            *reinterpret_cast<uint4*>(row + k) =
                make_uint4(out[0], out[1], out[2], out[3]);
            pf += __popc(mis);
        }
        if (st >= 0 && part == 0) {
            ctot[c] = total;
            if (total <= a.prefilter_mm) misc[0] = 1;  // §6 prefilter
        }
    }
    __syncthreads();
    STAMP(5);
    // The viable pairs, compacted in row-major order.
    int npairs = 0, before = 0;
    for (int w = 0; w < kWarps; ++w) {
        const int n = __popc(pmask[w]);
        npairs += n;
        before += w < warp ? n : 0;
    }
    if (viable)
        plist[before + __popc(pmask[warp] & ((1u << lane) - 1u))] =
            (uint8_t)tid;
    __syncthreads();
    STAMP(6);

    // --- 4. the viable pairs, g lanes each (g = 32 for up to 8 pairs,
    // down to 1 for more than 128): its lanes take splits k = lo + sub,
    // lo + sub + g, ... and reduce by shuffles.
    int g = 32;
    while (g > 1 && npairs * g > kThreads) g >>= 1;
    const int groups = kThreads / g, gi = tid / g, sub = tid - gi * g;
    const int lo = al, hi = len - al < Lp ? len - al : Lp;
    for (int p0 = 0; p0 + warp * (32 / g) < npairs; p0 += groups) {
        const int p = p0 + gi;
        const bool active = p < npairs;
        const int idx = active ? plist[p] : 0;  // row-major i * K + j
        const int i = idx / K, j = idx - i * K;
        const int s = cstr[i];
        const uint32_t pA = s == 0 ? cpos[i] : cpos[K + j];
        const uint32_t pB = s == 0 ? cpos[K + j] : cpos[i];
        const uint32_t endB = pB + ua;
        const bool circular = endB <= pA;
        const int16_t* ra = rows + i * L.stride;
        const int16_t* rb = rows + (K + j) * L.stride;
        const int tot = active ? ctot[s == 0 ? K + j : i] : 0;
        // The packed split key (score, !canon+, !canon-, k) and the
        // minimum score with the splits at it.
        int kmin = kNoSplit, msc = 0x7fffffff, nat = 0;
        for (int k = lo + sub; active && k <= hi; k += g) {
            const int x = ra[k], y = rb[k];
            const int sc = (x >> 2) + (y >> 2) + tot;
            const int key = (sc * 4 + 3 - (x & y & 3)) * (Lp + 2) + k;
            kmin = key < kmin ? key : kmin;
            if (sc < msc) {
                msc = sc;
                nat = 1;
            } else if (sc == msc) {
                ++nat;
            }
        }
        int gmsc = msc;
        for (int o = g >> 1; o > 0; o >>= 1) {
            const int k2 = __shfl_xor_sync(kFull, kmin, o);
            const int m2 = __shfl_xor_sync(kFull, gmsc, o);
            kmin = k2 < kmin ? k2 : kmin;
            gmsc = m2 < gmsc ? m2 : gmsc;
        }
        int n_at = msc == gmsc ? nat : 0;
        for (int o = g >> 1; o > 0; o >>= 1)
            n_at += __shfl_xor_sync(kFull, n_at, o);
        if (active && sub == 0) {
            const int edits = lo <= hi ? gmsc : kBig;
            const int n_bp = lo <= hi ? n_at : 0;
            const int best_k = kmin % (Lp + 2), rest = kmin / (Lp + 2);
            const bool cm_b = (rest & 1) == 0, cp_b = ((rest >> 1) & 1) == 0;
            const uint32_t donor = pA + (uint32_t)best_k;
            const uint32_t acceptor = endB + (uint32_t)best_k - (uint32_t)len;
            const uint32_t startj = circular ? acceptor : donor;
            const uint32_t endj = circular ? donor : acceptor;
            const unsigned e1 =
                (unsigned)edits * 4u + (cp_b ? 0u : 2u) + (cm_b ? 0u : 1u);
            // A linear pair whose junction ends before it starts is not
            // viable: it neither wins nor competes.
            pkey_hi[p] = circular || endj > startj
                             ? (unsigned long long)e1 << 32 | pA
                             : ~0ull;
            pkey_lo[p] = (unsigned long long)pB << 32 | (unsigned)s << 16 |
                         (unsigned)idx;
            pstart[p] = startj;
            pend[p] = endj;
            pkn[p] = (unsigned)best_k | (unsigned)n_bp << 16;
        }
    }
    __syncthreads();
    STAMP(7);
    if (warp != 0) return;

    // --- 5. the frozen pair tie-break (edits, !c+, !c-, pA, pB, s), then
    // row-major order, as one lexicographic minimum of the 96-bit key
    // (pkey_hi, pkey_lo) over the viable pairs. The plain code fills the
    // other pairs with BIG, so a pair without a split (edits BIG) wins
    // only when every one of the K x K pairs is viable.
    unsigned long long bh = ~0ull, bl = ~0ull;
    int bp = -1, nok = 0;
    for (int p = lane; p < npairs; p += 32) {
        const unsigned long long h = pkey_hi[p], l = pkey_lo[p];
        if (h == ~0ull) continue;
        ++nok;
        if (h < bh || (h == bh && l < bl)) {
            bh = h;
            bl = l;
            bp = p;
        }
    }
    nok = __reduce_add_sync(kFull, nok);
    const unsigned m1 = __reduce_min_sync(kFull, (unsigned)(bh >> 32));
    bool keep = (unsigned)(bh >> 32) == m1;
    const unsigned m2 = __reduce_min_sync(kFull, keep ? (unsigned)bh : kFull);
    keep = keep && (unsigned)bh == m2;
    const unsigned m3 =
        __reduce_min_sync(kFull, keep ? (unsigned)(bl >> 32) : kFull);
    keep = keep && (unsigned)(bl >> 32) == m3;
    const unsigned m4 = __reduce_min_sync(kFull, keep ? (unsigned)bl : kFull);
    keep = keep && (unsigned)bl == m4 && bp >= 0;
    const bool any_pair = nok > 0 && (m1 < (unsigned)kBig || nok == KK);
    const int owner = __ffs(__ballot_sync(kFull, keep)) - 1;
    const int wp = __shfl_sync(kFull, bp, owner < 0 ? 0 : owner);
    unsigned edits_s = 0, k_s = 0, s_s = 0, kind_s = 0, start_s = 0,
             end_s = 0, nbp_s = 0;
    uint32_t pA_s = 0, pB_s = 0;
    bool cp_s = false, cm_s = false;
    int wi = 0, wj = 0;
    if (any_pair) {
        edits_s = m1 >> 2;
        cp_s = ((m1 >> 1) & 1) == 0;
        cm_s = (m1 & 1) == 0;
        pA_s = m2;
        pB_s = m3;
        s_s = (m4 >> 16) & 1;
        wi = (int)(m4 & 0xffff) / K;
        wj = (int)(m4 & 0xffff) - wi * K;
        kind_s = pB_s + ua <= pA_s ? kCircular : kLinear;
        start_s = pstart[wp];
        end_s = pend[wp];
        k_s = pkn[wp] & 0xffff;
        nbp_s = pkn[wp] >> 16;
    }
    // Pair-margin rescue [FROZEN v4]: min edits over viable pairs at other
    // (kind, start, end) than the winner.
    unsigned alt = kBig;
    if (a.pair_rescue) {
        for (int p = lane; p < npairs; p += 32) {
            const unsigned long long h = pkey_hi[p];
            if (h == ~0ull) continue;
            const uint32_t pA = (uint32_t)h;
            const uint32_t pB = (uint32_t)(pkey_lo[p] >> 32);
            const unsigned kind = pB + ua <= pA ? kCircular : kLinear;
            const unsigned e = (unsigned)(h >> 32) >> 2;
            if ((kind != kind_s || pstart[p] != start_s || pend[p] != end_s)
                && e < alt)
                alt = e;
        }
        alt = __reduce_min_sync(kFull, alt);
    }
    if (lane != 0) return;
    STAMP(kStamps - 1);

    // --- the epilogue: signal, overlap, status chain, qual, the row ------
    const int* ha = hit;
    const int* hb = hit + kHitFields;
    int d0 = 0, d1 = 0, a0 = 0, a1 = 0;
    if (any_pair) {
        const int cl = s_s == 0 ? wi : K + wj;
        const int cr = s_s == 0 ? K + wj : wi;
        const int k0 = (int)k_s < Lp + 1 ? (int)k_s : Lp + 1;
        const int k1 = (int)k_s + 1 < Lp + 1 ? (int)k_s + 1 : Lp + 1;
        d0 = window_base(wsm + cl * nw, cs0[cl], k0);
        d1 = window_base(wsm + cl * nw, cs0[cl], k1);
        a0 = window_base(wsm + cr * nw, cs0[cr], k0);
        a1 = window_base(wsm + cr * nw, cs0[cr], k1);
    }
    const int sense = cp_s ? 0 : (cm_s ? kSenseMinus : (int)s_s);
    int sig[4] = {d0, d1, a0, a1};
    if (sense == kSenseMinus) {
        sig[0] = comp(a1);
        sig[1] = comp(a0);
        sig[2] = comp(d1);
        sig[3] = comp(d0);
    }
    // anchor_overlap at the winning split (SPEC §4).
    const uint32_t endB_s = pB_s + ua;
    const uint32_t e_a = pA_s + k_s, s_b = endB_s + k_s - (uint32_t)len;
    const uint32_t min_e = e_a < endB_s ? e_a : endB_s;
    const uint32_t max_s = pA_s > s_b ? pA_s : s_b;
    const uint32_t overlap = min_e > max_s ? min_e - max_s : 0u;

    // Status [FROZEN §2b priority]: prefiltered > unaligned_A >
    // unaligned_B > junction > the v2 single-best fallback chain.
    const uint32_t posa = (uint32_t)hpos[0], posb = (uint32_t)hpos[1];
    const int sa = ha[hStrand], sb = hb[hStrand];
    const bool minus1 = sa == 1;
    const uint32_t pA1 = minus1 ? posb : posa, pB1 = minus1 ? posa : posb;
    const bool geom1 = pA1 + ua <= pB1 || pB1 + ua <= pA1;
    int status = sa != sb ? kDiffStrand
                 : upper(offs, a.n_chroms, posa) !=
                         upper(offs, a.n_chroms, posb)
                     ? kDiffChrom
                     : (geom1 ? kNoJunction : kAnchorOverlap);
    if (any_pair) status = kJunction;
    if (!hb[hAligned]) status = kUnalignedB;
    if (!ha[hAligned]) status = kUnalignedA;
    if (a.prefilter && misc[0]) status = kPrefiltered;

    int ql = s_s == 0 ? ha[hQual] : hb[hQual];
    int qr = s_s == 0 ? hb[hQual] : ha[hQual];
    if (a.pair_rescue) {
        const int margin =
            alt >= (unsigned)kBig ? al + 1 : (int)alt - (int)edits_s;
        const bool multi = ha[hNbest] > 1 || hb[hNbest] > 1;
        const int rq = any_pair && multi && margin > 0
                           ? (10 * margin < 40 ? 10 * margin : 40)
                           : 0;
        ql = ql > rq ? ql : rq;
        qr = qr > rq ? qr : rq;
    }
    int32_t* o = a.out + (size_t)b * kPackFields;
    o[0] = status;
    o[1] = (int)kind_s;
    o[2] = any_pair ? cch[wi] : 0;
    o[3] = (int)start_s;
    o[4] = (int)end_s;
    o[5] = sense;
    o[6] = (int)s_s;
    o[7] = (int)edits_s;
    o[8] = (int)nbp_s;
    o[9] = (int)overlap;
    o[10] = ql;
    o[11] = qr;
    o[12] = 0;  // multi: the rows are final
    o[13] = sig[0] | (sig[1] << 3) | (sig[2] << 6) | (sig[3] << 9);
}

}  // namespace

// Host side: the C entry.

// out[b] = the §2b packed row of read b, for every read of the chunk.
extern "C" int fc2t_explore(const ExploreArgs* a) {
    if (a->B <= 0) return 0;
    // int16 split rows hold up to 4 * Lp + 3.
    if (a->K < 1 || a->K > kMaxK || a->Lp < 1 || a->Lp > 4096 ||
        a->V < 1 || a->V * a->K > kMaxListLanes || a->n_chroms < 1)
        return -(int)cudaErrorInvalidValue;
    int dev = -1;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -(int)err;
    if (dev != a->device) return -(int)cudaErrorInvalidDevice;
    const int n_offs = a->n_chroms <= kChromShared ? a->n_chroms : 0;
    const size_t smem_bytes = layout(a->Lp, a->K, a->V, n_offs).total;
    if (smem_bytes > 48 * 1024) {
        err = cudaFuncSetAttribute(explore_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes);
        if (err != cudaSuccess) return -(int)err;
    }
    explore_kernel<<<(unsigned)a->B, kThreads, smem_bytes,
                     static_cast<cudaStream_t>(a->stream)>>>(*a, n_offs);
    err = cudaGetLastError();
    return err == cudaSuccess ? 1 : -(int)err;
}

// What the compiled kernel takes on the current device for reads of
// Lp bases, K hits, V variants and n_chroms chromosomes: out[0] registers
// a thread, out[1] local (spilled) bytes a thread, out[2] shared bytes a
// block, out[3] resident blocks an SM, out[4] threads a block. Returns 0
// or minus a CUDA error.
extern "C" int fc2t_explore_resources(int Lp, int K, int V, int n_chroms,
                                      int* out) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, explore_kernel);
    if (err != cudaSuccess) return -(int)err;
    const int n_offs = n_chroms <= kChromShared ? n_chroms : 0;
    const size_t smem_bytes = layout(Lp, K, V, n_offs).total;
    if (smem_bytes > 48 * 1024) {
        err = cudaFuncSetAttribute(explore_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes);
        if (err != cudaSuccess) return -(int)err;
    }
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, explore_kernel, kThreads, smem_bytes);
    if (err != cudaSuccess) return -(int)err;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = (int)(smem_bytes + fa.sharedSizeBytes);
    out[3] = blocks;
    out[4] = kThreads;
    return 0;
}

#ifdef FC2T_EXPLORE_STAMPS
// Where the next launches record their stage clocks (null: nowhere).
extern "C" int fc2t_explore_stamps(void* stamps) {
    unsigned long long* p = static_cast<unsigned long long*>(stamps);
    const cudaError_t err = cudaMemcpyToSymbol(fc2t_stamps, &p, sizeof p);
    return err == cudaSuccess ? 0 : -(int)err;
}
#endif
