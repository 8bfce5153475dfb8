// K1 v4's exact-first probe (K-b) of a batch's stacked anchors: one thread
// per anchor, one launch per batch.
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
// eight slot compares) is less. Each row is one random access into a
// table larger than the L2, so the design issues all four row loads of a
// thread before it uses any of them, 16 bytes at a time, and keeps
// everything else in registers. No shared memory, no tensor cores, no
// TMA: nothing is shared between anchors, and the loads are
// data-dependent 32-byte rows.
//
// Kept bit for bit: when a key's two buckets are one bucket both probes
// match its slot and their counts add (ROADMAP.md §3); a dirty anchor
// (a code >= 4) is looked up on its codes with those zeroed, is not
// clean, and resolves; exact counts above max_bucket count as 0.
//
// Plain C interface for ctypes: one packed argument buffer (ExactArgs).
// The entry returns the kernels it launched (1, or 0 for no anchors), or
// minus a CUDA error.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "cuckoo.cuh"

// The arguments of one call, packed by ops/anchor_align.py into one
// buffer.
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
    void* stream;
    long long rows;           // table rows; a bucket at or past it reads empty
    int n, anchor_len, prefix_len, max_bucket, max_anchor_mm, device;
};
static_assert(sizeof(ExactArgs) == 136, "layout packed by ops/anchor_align");

namespace {

using fc2t::holds;
using fc2t::kCntBits;
using fc2t::kCntMask;
using fc2t::kLargeMm;
using fc2t::kLargePos;
using fc2t::kSlots;
using fc2t::mix_hash;

constexpr int kThreads = 128;
// The neighbour table's lanes (index/hashtable.py NBR_LANES): one int4 a
// slot, as the table's.
constexpr int kNbrLanes = 4;
static_assert(kNbrLanes == fc2t::kLanes, "a slot is one int4 a table");
constexpr int kMaxAnchor = 32;

// One probe's two slots against the canonical key (cp, cs), folded into
// the anchor's sums and minima (exact_partials' probe).
struct Partials {
    bool found = false;
    long long cf = 0, cr = 0, s1f = 0, s1r = 0;
    uint32_t pf = kLargePos, pr = kLargePos, m1f = kLargePos,
             m1r = kLargePos;

    __device__ void add(const int4 (&g)[2], const int4 (&nb)[2],
                        long long cp, uint32_t cs) {
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
            const int4 r = g[t], q = nb[t];
            const unsigned packed = (unsigned)r.y;
            if (!holds(r, cp, cs)) continue;
            found = true;
            cf += (packed >> 16) & kCntMask;
            cr += (packed >> (16 + kCntBits)) & kCntMask;
            pf = min(pf, (uint32_t)r.z);
            pr = min(pr, (uint32_t)r.w);
            s1f += q.x;
            m1f = min(m1f, (uint32_t)q.y);
            s1r += q.z;
            m1r = min(m1r, (uint32_t)q.w);
        }
    }
};

__global__ void __launch_bounds__(kThreads)
exact_kernel(const __grid_constant__ ExactArgs a) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= a.n) return;
    const int al = a.anchor_len, pk = a.prefix_len, sk = al - pk;
    const uint8_t* anc = a.anchors + (size_t)i * al;

    // _exact_keys: the forward key (p12, s8) and its reverse complement's,
    // on the codes with those >= 4 zeroed.
    bool clean = true;
    unsigned long long p12 = 0, s8 = 0, p12r = 0, s8r = 0;
    for (int j = 0; j < al; ++j) {
        const int c = anc[j];
        clean = clean && c < 4;
        const unsigned long long q = c < 4 ? (unsigned)c : 0u;
        if (j < pk)
            p12 = p12 * 4 + q;
        else
            s8 = s8 * 4 + q;
        // The reverse complement's digit j from the end is 3 - q.
        if (j >= al - pk) p12r += (3 - q) << (2 * (j - (al - pk)));
        if (j < sk) s8r += (3 - q) << (2 * j);
    }
    const bool swap = p12r < p12 || (p12r == p12 && s8r < s8);
    const unsigned long long cp = swap ? p12r : p12;
    const unsigned long long cs = swap ? s8r : s8;

    // Both probes' buckets, then all four rows in flight at once.
    const uint32_t n_buckets = (uint32_t)a.meta[2];
    uint32_t h[2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
        h[t] = mix_hash((uint32_t)cp, (uint32_t)cs, (uint32_t)a.meta[t]) %
               n_buckets;
    int4 g[2][2], nb[2][2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
        const bool in = (long long)h[t] < a.rows;
        const int4* tr = reinterpret_cast<const int4*>(a.table) +
                         (size_t)h[t] * kSlots;
        const int4* nr = reinterpret_cast<const int4*>(a.ntable) +
                         (size_t)h[t] * kSlots;
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
            g[t][u] = in ? __ldg(tr + u) : make_int4(-1, 0, 0, 0);
            nb[t][u] = in ? __ldg(nr + u) : make_int4(0, 0, 0, 0);
        }
    }
    Partials p;
    p.add(g[0], nb[0], (long long)cp, (uint32_t)cs);
    p.add(g[1], nb[1], (long long)cp, (uint32_t)cs);

    // exact_finish: the guard on the exact counts, the orientation of the
    // query, the frozen best-hit selection and the MAPQ surrogate.
    const bool usable = p.found && clean;
    const long long cf_t = usable && p.cf <= a.max_bucket ? p.cf : 0;
    const long long cr_t = usable && p.cr <= a.max_bucket ? p.cr : 0;
    const long long s1f_t = usable ? p.s1f : 0;
    const long long s1r_t = usable ? p.s1r : 0;
    const long long exact_p = swap ? cr_t : cf_t;
    const long long exact_m = swap ? cf_t : cr_t;
    const uint32_t posx_p = swap ? p.pr : p.pf, posx_m = swap ? p.pf : p.pr;
    const long long s1_p = swap ? s1r_t : s1f_t;
    const long long s1_m = swap ? s1f_t : s1r_t;
    const uint32_t mp1_p = swap ? p.m1r : p.m1f, mp1_m = swap ? p.m1f : p.m1r;
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
    a.aligned[i] = m0 <= a.max_anchor_mm;
    a.pos[i] = (int64_t)pos;
    a.strand[i] = strand;
    a.mm[i] = m0;
    a.n_best[i] = (int32_t)n_best;
    a.second_mm[i] = second_mm;
    a.qual[i] = n_best > 1 ? 0 : (q10 < 40 ? q10 : 40);
    a.resolved[i] = p.found || !clean;
}

}  // namespace

// Host side: the C entry.

// The exact-first statistics and `resolved` of every anchor.
extern "C" int fc2t_exact_stats(const ExactArgs* a) {
    if (a->n <= 0) return 0;
    if (a->anchor_len < 1 || a->anchor_len > kMaxAnchor ||
        a->prefix_len < 1 || a->prefix_len >= a->anchor_len ||
        a->anchor_len - a->prefix_len > 8 || a->rows < 1)
        return -(int)cudaErrorInvalidValue;
    int dev = -1;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -(int)err;
    if (dev != a->device) return -(int)cudaErrorInvalidDevice;
    const unsigned blocks = (unsigned)((a->n + kThreads - 1) / kThreads);
    exact_kernel<<<blocks, kThreads, 0,
                   static_cast<cudaStream_t>(a->stream)>>>(*a);
    err = cudaGetLastError();
    return err == cudaSuccess ? 1 : -(int)err;
}
