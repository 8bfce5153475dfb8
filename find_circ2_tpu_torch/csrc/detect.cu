// Detect's per-read core (K-e + K-f) of one batch: one warp per read, one
// launch per batch.
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
// reads and their reverse complements, the hit fields, four 22-word
// windows a read, the [B, 14] rows): about a microsecond at 3.35 TB/s.
// Its arithmetic, about a dozen 32-bit operations for each of a read's
// Lp + 1 splits, is less. chip_smoke.py computes both from each run's
// shapes. The windows are data-dependent gathers of 88 bytes, so neither
// tensor cores nor TMA apply; what the design does:
//
//  - One warp a read, eight reads a block. Lane g takes splits 8g .. 8g+7
//    as nibble words (csrc/nibbles.cuh), reading the windows straight
//    from the genome's words; a warp scan of the lanes' mismatch counts
//    gives each lane its prefix, so the split grid never exists.
//  - The score at split k is prefA(k) + totB - prefB(k); totB is one
//    constant of the read, so the lanes minimize the packed key with
//    d(k) = prefA(k) - prefB(k) in its place (same order, same first
//    minimum) and add totB to the minimum at the end.
//  - The prefilter's two Hamming counts use the same lanes and words.
//
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

namespace {

using fc2t::comp;
using fc2t::mismatches;
using fc2t::nibbles;
using fc2t::same;
using fc2t::upper;
using fc2t::window_base;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;     // one read a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 20;             // ops/breakpoint.py BIG
constexpr int kNoSplit = 0x7fffffff;      // no valid split
constexpr int kPackFields = 14;
// config.py's codes.
constexpr int kA = 0, kC = 1, kG = 2, kT = 3, kRpad = 6;
constexpr int kJunction = 0, kPrefiltered = 3, kUnalignedA = 4,
              kUnalignedB = 5, kDiffStrand = 6, kDiffChrom = 7,
              kAnchorOverlap = 8, kNoJunction = 9;
constexpr int kLinear = 0, kCircular = 1, kSensePlus = 0, kSenseMinus = 1;

// Bases p .. p+7 of a [Lp] row of codes as nibbles, base p lowest;
// RPAD past Lp.
__device__ __forceinline__ uint32_t row_nibbles(const uint8_t* row, int p,
                                                int Lp) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int q = p + j;
        w |= (uint32_t)(q < Lp ? row[q] : kRpad) << (4 * j);
    }
    return w;
}

__global__ void __launch_bounds__(kThreads)
detect_kernel(const __grid_constant__ DetectArgs a) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (b >= a.B) return;  // whole warps leave together
    const int Lp = a.Lp, al = a.anchor_len;
    const uint32_t ua = (uint32_t)al;
    const int len = a.lens[b];
    const uint8_t* read = a.reads + (size_t)b * Lp;
    const uint8_t* rcrow = a.rc + (size_t)b * Lp;
    const DetectAnchor& A = a.anchor[0];
    const DetectAnchor& Bn = a.anchor[1];
    const long long pos_a = A.pos[b], pos_b = Bn.pos[b];
    const uint32_t ua_pos = (uint32_t)pos_a, ub_pos = (uint32_t)pos_b;
    const int str_a = A.strand[b], str_b = Bn.strand[b];
    const bool al_a = A.aligned[b] != 0, al_b = Bn.aligned[b] != 0;
    const auto* words = reinterpret_cast<const uint32_t*>(a.words);

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
    const uint32_t* wA = words + (sA >> 3);
    const uint32_t* wB = words + (sB >> 3);
    const uint32_t* wPa = words + (pf_a >> 3);
    const uint32_t* wPb = words + (pf_b >> 3);

    // Lane g of each round takes splits k = 8g .. 8g+7 (and read bases
    // p = k): its mismatch counts against GA and GB, scanned over the
    // lanes, give prefA(k) and prefB(k).
    const int lim = len < Lp ? len : Lp;  // bases compared: [0, lim)
    const int kmax_valid = len - al;      // valid k in [al, len - al]
    int carryA = 0, carryB = 0, mm_a = 0, mm_b = 0;
    int best_key = kNoSplit, best_d = kNoSplit, n_at = 0;
    for (int g0 = 0; 8 * g0 <= Lp; g0 += 32) {
        const int k0 = 8 * (g0 + lane);
        const bool live = k0 <= Lp;
        uint32_t misA = 0, misB = 0;
        uint32_t qf = 0, qr = 0;
        if (live) {
            qf = row_nibbles(read, k0, Lp);
            qr = row_nibbles(rcrow, k0, Lp);
            const uint32_t q = minus ? qr : qf;
            if (lim - k0 > 0) {
                misA = mismatches(q, nibbles(wA, sA, k0), lim - k0);
                misB = mismatches(q, nibbles(wB, sB, k0 + 2), lim - k0);
                if (a.prefilter) {
                    mm_a += __popc(mismatches(fwd_a ? qf : qr,
                                              nibbles(wPa, pf_a, k0),
                                              lim - k0));
                    mm_b += __popc(mismatches(fwd_b ? qf : qr,
                                              nibbles(wPb, pf_b, k0),
                                              lim - k0));
                }
            }
        }
        const int nA = __popc(misA), nB = __popc(misB);
        int incA = nA, incB = nB;  // inclusive scans over the lanes
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int yA = __shfl_up_sync(kFull, incA, d);
            const int yB = __shfl_up_sync(kFull, incB, d);
            if (lane >= d) {
                incA += yA;
                incB += yB;
            }
        }
        const int preA = carryA + incA - nA, preB = carryB + incB - nB;
        carryA += __shfl_sync(kFull, incA, 31);
        carryB += __shfl_sync(kFull, incB, 31);
        if (!live || k0 > kmax_valid || k0 + 7 < al) continue;
        // Canonical dinucleotides of every split of the lane: donor
        // GA[k], GA[k+1]; acceptor GB[k], GB[k+1].
        const uint32_t d0 = nibbles(wA, sA, k0), d1 = nibbles(wA, sA, k0 + 1);
        const uint32_t a0 = nibbles(wB, sB, k0), a1 = nibbles(wB, sB, k0 + 1);
        const uint32_t cp = same(d0, kG) & same(d1, kT) & same(a0, kA) &
                            same(a1, kG);
        const uint32_t cm = same(d0, kC) & same(d1, kT) & same(a0, kA) &
                            same(a1, kC);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int k = k0 + j;
            if (k < al || k > kmax_valid || k > Lp) continue;
            const uint32_t below = (1u << (4 * j)) - 1u;
            const int dk = (preA + __popc(misA & below)) -
                           (preB + __popc(misB & below));
            // Frozen tie-break (score, !canon+, !canon-, k), with d(k)
            // + Lp >= 0 for the score.
            const int key = ((dk + Lp) * 8 + (((cp >> (4 * j)) & 1) ? 0 : 4) +
                             (((cm >> (4 * j)) & 1) ? 0 : 2)) *
                                (Lp + 2) +
                            k;
            best_key = key < best_key ? key : best_key;
            if (dk < best_d) {
                best_d = dk;
                n_at = 1;
            } else if (dk == best_d) {
                ++n_at;
            }
        }
    }
    const int totB = carryB;
    const int key_min = __reduce_min_sync(kFull, best_key);
    const int d_min = __reduce_min_sync(kFull, best_d);
    const int n_bp = __reduce_add_sync(kFull, best_d == d_min ? n_at : 0);
    mm_a = __reduce_add_sync(kFull, mm_a);
    mm_b = __reduce_add_sync(kFull, mm_b);
    if (lane != 0) return;

    const bool any_split = key_min != kNoSplit;
    const int best_k = any_split ? key_min % (Lp + 2) : 0;
    const int edits = any_split ? d_min + totB : kBig;

    // The best split's junction, dinucleotides and sense.
    const uint32_t uk = (uint32_t)best_k;
    const uint32_t donor = pA + uk;
    const uint32_t acceptor = endB + uk - (uint32_t)len;
    const uint32_t start = circular ? acceptor : donor;
    const uint32_t end = circular ? donor : acceptor;
    const int d0 = window_base(wA, sA, best_k);
    const int d1 = window_base(wA, sA, best_k + 1);
    const int a0 = window_base(wB, sB, best_k);
    const int a1 = window_base(wB, sB, best_k + 1);
    const bool canon_p = d0 == kG && d1 == kT && a0 == kA && a1 == kG;
    const bool canon_m = d0 == kC && d1 == kT && a0 == kA && a1 == kC;
    const int sense = canon_p ? kSensePlus : canon_m ? kSenseMinus : s;
    int sig[4] = {d0, d1, a0, a1};
    if (sense == kSenseMinus) {
        sig[0] = comp(a1);
        sig[1] = comp(a0);
        sig[2] = comp(d1);
        sig[3] = comp(d0);
    }
    // Anchor overlap at the best split: max(0, min_e - max_s).
    const uint32_t e_a = pA + uk, s_b = endB + uk - (uint32_t)len;
    const uint32_t min_e = e_a < endB ? e_a : endB;
    const uint32_t max_s = pA > s_b ? pA : s_b;
    const uint32_t overlap = min_e > max_s ? min_e - max_s : 0u;

    // Status [FROZEN priority]: prefiltered > unaligned_A > unaligned_B >
    // diff_strand > diff_chrom > anchors_overlap > no_junction >
    // junction.
    const int chrom_a = upper(a.chrom_offsets, a.n_chroms, pos_a) - 1;
    const int chrom_b = upper(a.chrom_offsets, a.n_chroms, pos_b) - 1;
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
    const int overflow = a.overflow ? (a.overflow[0] != 0) : 0;
    const int multi = (A.n_best[b] > 1 || Bn.n_best[b] > 1 ? 1 : 0) |
                      (al_a != al_b ? 2 : 0) | overflow << 3;

    int32_t* o = a.out + (size_t)b * kPackFields;
    o[0] = status;
    o[1] = circular ? kCircular : kLinear;
    o[2] = chrom_a;
    o[3] = (int)start;
    o[4] = (int)end;
    o[5] = sense;
    o[6] = s;
    o[7] = edits;
    o[8] = n_bp;
    o[9] = (int)overlap;
    o[10] = minus ? Bn.qual[b] : A.qual[b];
    o[11] = minus ? A.qual[b] : Bn.qual[b];
    o[12] = multi;
    o[13] = sig[0] | (sig[1] << 3) | (sig[2] << 6) | (sig[3] << 9);
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
    const unsigned blocks = (unsigned)((a->B + kWarps - 1) / kWarps);
    detect_kernel<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(a->stream)>>>(*a);
    err = cudaGetLastError();
    return err == cudaSuccess ? 1 : -(int)err;
}
