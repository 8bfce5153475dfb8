// K1's cross-shard combine and finish on the sharded engine: one thread
// per anchor (or fallback-slice slot), one launch per combine.
//
// Replaces, on a data row of parallel/sharded.py, the plain versions in
// find_circ2_tpu_torch/ops/anchor_align.py: _combine (a torch.stack and a
// sum, amin or any per field over the index shards), exact_finish with
// _exact_keys' `clean` and `swap` (the exact-first probe's guard, the
// orientation of the query and the frozen SPEC §2 statistics, with
// `resolved`), finalize_hits with _hits (the classic enumeration's
// frozen best hit) and _scatter (the fallback slice's hits written over
// the probe's with seven index_copy calls). The reference computes the
// same inside its per-shard programs, with psum/pmin collectives
// (find_circ2_tpu/ops/anchor_align.py:286-291 in finalize_hits, :424-438
// in exact_anchor_stats), not Pallas.
//
// The records come from each shard's partials mode of csrc/exact_stats.cu
// (nine int32 fields an anchor) or csrc/classic_k1.cu (eight), stacked
// [shards, n, fields] on the row's device; positions are uint32 bit
// patterns, so they are least as unsigned numbers.
//
// What bounds it on this card: bytes. Each anchor reads shards x fields
// x 4 bytes (288 at four shards of exact records) and its anchor's 20
// codes, and writes about 30 bytes; a few dozen integer operations a
// shard. 8192 anchors are about 2.6 MB, under a microsecond at 3.35
// TB/s, and no row is random: consecutive threads read consecutive
// records, so a warp's loads of one shard's plane cover whole sectors.
// The design is the plain loop: one thread an anchor, 128 a block.
//
// Kept bit for bit: the guard applies to the exact counts summed over
// the shards (the classic records come guarded per shard, as
// candidate_stats guards); a dirty anchor (a code >= 4) is not clean and
// resolves with empty statistics; a position is taken only where its
// count is above 0 (csrc/classic_k1.cu masks the records so).
//
// Plain C interface for ctypes: one packed argument buffer (ShardArgs).
// The entry returns the kernels it launched (1, or 0 for no rows), or
// minus a CUDA error.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "cuckoo.cuh"

// The arguments of one combine, packed by ops/anchor_align.py into one
// buffer. Exact records (fields == 9) finish as exact_finish and write
// `resolved`; classic records (fields == 8) finish as finalize_hits, at
// row s or, with `slots`, at slots[s] (in place, over the probe's hits).
struct ShardArgs {
    const int32_t* records;   // [shards, n, fields]
    const uint8_t* anchors;   // [n, anchor_len] codes (exact records)
    const int64_t* slots;     // [n], or null
    uint8_t* aligned;         // the AnchorHits fields
    int64_t* pos;             // uint32 values
    int32_t* strand;
    int32_t* mm;
    int32_t* n_best;
    int32_t* second_mm;
    int32_t* qual;
    uint8_t* resolved;        // [n] bool (exact records), or null
    void* stream;
    long long n;              // record rows
    int shards, fields, anchor_len, prefix_len, max_bucket, max_anchor_mm,
        device, reserved;
};
static_assert(sizeof(ShardArgs) == 136, "layout packed by ops/anchor_align");

namespace {

using fc2t::kLargeMm;
using fc2t::kLargePos;

constexpr int kThreads = 128;
// csrc/exact_stats.cu's and csrc/classic_k1.cu's record widths.
constexpr int kExactFields = 9, kClassicFields = 8;
// The most shards a call takes (the mesh's index axis).
constexpr int kMaxShards = 64;

__global__ void __launch_bounds__(kThreads)
finish_kernel(const __grid_constant__ ShardArgs a) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= a.n) return;
    const size_t plane = (size_t)a.n * a.fields;
    const int32_t* rec = a.records + (size_t)i * a.fields;
    const int al = a.anchor_len;
    // The exact counts of each strand, their sum, the total at mm <= 1,
    // the '+' strand's count at mm 1 (or at both), and the least
    // positions at mm 0 and 1 on each strand.
    long long exact_p, exact_m, total, half_p, n_exact;
    uint32_t x_p, x_m, one_p, one_m;
    bool found = false, clean = true;
    if (a.fields == kExactFields) {
        long long cf = 0, cr = 0, s1f = 0, s1r = 0;
        uint32_t pf = kLargePos, pr = kLargePos, m1f = kLargePos,
                 m1r = kLargePos;
        for (int s = 0; s < a.shards; ++s) {
            const int32_t* r = rec + s * plane;
            found = found || r[0] != 0;
            cf += r[1];
            pf = min(pf, (uint32_t)r[2]);
            cr += r[3];
            pr = min(pr, (uint32_t)r[4]);
            s1f += r[5];
            m1f = min(m1f, (uint32_t)r[6]);
            s1r += r[7];
            m1r = min(m1r, (uint32_t)r[8]);
        }
        // exact_finish: the guard on the summed exact counts, `clean`,
        // then the query's orientation.
        const fc2t::ExactKey key =
            fc2t::exact_key(a.anchors + (size_t)i * al, al, a.prefix_len);
        clean = key.clean;
        const bool usable = found && clean;
        const long long cf_t = usable && cf <= a.max_bucket ? cf : 0;
        const long long cr_t = usable && cr <= a.max_bucket ? cr : 0;
        const long long s1f_t = usable ? s1f : 0;
        const long long s1r_t = usable ? s1r : 0;
        exact_p = key.swap ? cr_t : cf_t;
        exact_m = key.swap ? cf_t : cr_t;
        const long long s1_p = key.swap ? s1r_t : s1f_t;
        const long long s1_m = key.swap ? s1f_t : s1r_t;
        n_exact = exact_p + exact_m;
        total = n_exact + s1_p + s1_m;
        half_p = s1_p;  // what has_p reads when no exact hit
        // A position counts only with its count, as exact_finish takes it.
        x_p = exact_p > 0 ? (key.swap ? pr : pf) : kLargePos;
        x_m = exact_m > 0 ? (key.swap ? pf : pr) : kLargePos;
        one_p = key.swap ? m1r : m1f;
        one_m = key.swap ? m1f : m1r;
    } else {
        long long c0 = 0, cv = 0, sp = 0, sm = 0;
        uint32_t p0 = kLargePos, pv = kLargePos, pp = kLargePos,
                 pm = kLargePos;
        for (int s = 0; s < a.shards; ++s) {
            const int32_t* r = rec + s * plane;
            c0 += r[0];
            cv += r[1];
            sp += r[2];
            sm += r[3];
            p0 = min(p0, (uint32_t)r[4]);
            pv = min(pv, (uint32_t)r[5]);
            pp = min(pp, (uint32_t)r[6]);
            pm = min(pm, (uint32_t)r[7]);
        }
        // finalize_hits: the exact slots are 0 and V.
        exact_p = c0;
        exact_m = cv;
        n_exact = c0 + cv;
        total = sp + sm;
        half_p = sp;
        x_p = p0;
        x_m = pv;
        one_p = pp;
        one_m = pm;
    }
    const bool any_exact = n_exact > 0, any_at_all = total > 0;
    const int m0 = any_exact ? 0 : (any_at_all ? 1 : kLargeMm);
    const long long n_best = any_exact ? n_exact : total;
    const bool has_p = any_exact ? exact_p > 0 : half_p > 0;
    const int strand = has_p ? 0 : (any_at_all ? 1 : 2);
    const uint32_t pos = m0 == 0   ? (strand == 0   ? x_p
                                      : strand == 1 ? x_m
                                                    : kLargePos)
                         : m0 == 1 ? (strand == 0   ? one_p
                                      : strand == 1 ? one_m
                                                    : kLargePos)
                                   : kLargePos;
    // _hits.
    const int second_mm = n_best > 1 ? m0
                          : (m0 == 0 && total > n_exact) ? 1
                                                         : al + 1;
    const int q10 = 10 * (second_mm - m0);
    const long long o = a.slots ? a.slots[i] : i;
    a.aligned[o] = m0 <= a.max_anchor_mm;
    a.pos[o] = (int64_t)pos;
    a.strand[o] = strand;
    a.mm[o] = m0;
    a.n_best[o] = (int32_t)n_best;
    a.second_mm[o] = second_mm;
    a.qual[o] = n_best > 1 ? 0 : (q10 < 40 ? q10 : 40);
    if (a.resolved) a.resolved[i] = found || !clean;
}

}  // namespace

// Host side: the C entry.

// The combined hits (and, for exact records, `resolved`) of every row.
extern "C" int fc2t_shard_finish(const ShardArgs* a) {
    if (a->n <= 0) return 0;
    const bool exact = a->fields == kExactFields;
    if (a->shards < 1 || a->shards > kMaxShards ||
        (!exact && a->fields != kClassicFields) || a->anchor_len < 1 ||
        a->anchor_len > fc2t::kMaxKeyLen || a->prefix_len < 1 ||
        a->prefix_len >= a->anchor_len ||
        a->anchor_len - a->prefix_len > 8 ||
        exact != (a->anchors != nullptr) ||
        exact != (a->resolved != nullptr) || (exact && a->slots != nullptr))
        return -(int)cudaErrorInvalidValue;
    int dev = -1;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -(int)err;
    if (dev != a->device) return -(int)cudaErrorInvalidDevice;
    const unsigned blocks = (unsigned)((a->n + kThreads - 1) / kThreads);
    finish_kernel<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(a->stream)>>>(*a);
    err = cudaGetLastError();
    return err == cudaSuccess ? 1 : -(int)err;
}
