// §2b multi-hit pair exploration (K-g) of one chunk of routed reads: one
// thread block per read, one launch per chunk.
//
// Replaces, after K1 (candidate_stats, finalize_hits), everything of the
// plain explore_batch_packed in find_circ2_tpu_torch/ops/explore.py:
// merged_candidates for both anchors, _candidate_side for both,
// explore_core and models/pipeline._pack. The reference computes the same
// as XLA programs, not Pallas (find_circ2_tpu/ops/explore.py:61
// merged_candidates, :101 _candidate_side, :147 explore_core), with the
// prefix sums as a bf16 triangular-ones matmul and an int32
// [B, K, K, Lp+1] split grid in device memory. The plain PyTorch version
// (explore_pairs_ref) is about a thousand eager kernels a 1024-read chunk
// over int32 copies of that grid, 168.8 MB each at K = 16, Lp = 160.
//
// What bounds it on this card. The work is int32 arithmetic over (pair,
// split): each of a read's K x K = 256 pairs that can pair walks up to
// Lp - 2a + 1 = 121 splits at about 12 operations a split (the packed
// score and flags of two shared loads, three compares and selects), so
// at most 1024 x 256 x 121 x 12 = 0.38 G operations a 1024-read chunk.
// The bytes it must move are the reads, K1's count rows, the first_pos
// and extras lanes at each anchor's best mismatch level, the 2K
// (Lp+2)-base windows of nibble words and the [B, 14] rows: a few MB a
// chunk. At the H100's 67 T/s 32-bit rate and 3.35 TB/s both bounds are a
// few microseconds: the operations the larger at full pair counts, the
// bytes on the 16 Mbp library's routed reads (a few dozen pairs a read run
// their split loop). chip_smoke.py computes both from each run's data.
// Neither is what the kernel meets: its blocks wait on dependent global
// loads and block barriers (K1's rows, then the windows, then the
// reductions).
//
// Design (right first; making it fast is later work):
//  * Merge: each anchor's lanes at its best mismatch level (lane <
//    min(count, K)) go to shared memory per strand through a shared
//    counter, every thread's loads of a batch issued before its appends.
//    The K smallest per strand, duplicates kept as `sort` keeps them:
//    up to kRankMax entries each ranked against the others (ties by
//    index); more (up to 60 slots x 16 lanes at the 1-mismatch level, as
//    at high-copy repeats; PERF.md gives their share of routed reads) by K
//    rounds of a block minimum over (position, index), which costs K block
//    reductions, not n^2 compares. '+' entries before '-', capped at K.
//  * Candidate sides: one warp per candidate reads its (Lp+2)-base window
//    straight from the nibble words (start clamped as _candidate_side),
//    counts mismatches against the read or its reverse complement with a
//    warp scan, and keeps one int per split k: its role's mismatch count
//    (prefix for the left piece, suffix for the right) times 4 plus its
//    role's two dinucleotide flags. A pair's split score is then the sum
//    of its candidates' counts and its flags their AND: the split loop is
//    two bank-conflict-free shared loads (odd row stride).
//  * Pairs: thread i*K + j walks the splits of pair (i, j) and keeps the
//    minimum score, the number of splits at it and the minimum packed
//    split key; the split grid never exists in memory. A pair that cannot
//    pair (an invalid lane, two strands or chromosomes, neither geometry)
//    skips its loop: it can neither win nor compete below.
//  * The frozen pair tie-break as successive masked block minima with the
//    plain code's fills, the first pair in row-major order, the
//    pair-margin rescue's minimum over pairs at other coordinates; one
//    thread writes the row.
// Position arithmetic is uint32 and wraps where the plain code masks with
// & 0xFFFFFFFF.
//
// Plain C interface for ctypes: one packed argument buffer (ExploreArgs).
// The entry returns the kernels it launched (1, or 0 for an empty chunk),
// or minus a CUDA error.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;                 // merge loads in flight a thread
constexpr int kRankMax = 128;             // largest list ranked pairwise
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 16;                 // K * K pairs <= kThreads
constexpr uint32_t kLargePos = 0xffffffffu;
constexpr int kBig = 1 << 20;             // ops/explore.py BIG
constexpr int kNoSplit = 1 << 30;         // the split key's fill
constexpr unsigned kNone = 0xffffffffu;   // identity of the block minima
constexpr int kPackFields = 14;
// config.py's codes.
constexpr int kA = 0, kC = 1, kG = 2, kT = 3, kRpad = 6;
constexpr int kJunction = 0, kPrefiltered = 3, kUnalignedA = 4,
              kUnalignedB = 5, kDiffStrand = 6, kDiffChrom = 7,
              kAnchorOverlap = 8, kNoJunction = 9;
constexpr int kLinear = 0, kCircular = 1, kSenseMinus = 1;

// The winning pair's fields in shared memory.
enum Win { wKind, wStart, wEnd, wEdits, wNbp, wK, wS, wPA, wPB, wChrom,
           wCp, wCm, wI, wJ, kWinFields };

// Byte offsets of the block's shared memory (all dynamic), from Lp, K, V.
struct Layout {
    int stride;  // ints per candidate row of `split`, odd
    size_t split, red64, lanes, cpos, cstr, cval, sorted, counter, red, win,
        windows, read, rc, total;
};

__host__ __device__ inline Layout layout(int Lp, int K, int V) {
    Layout L;
    L.stride = (Lp + 1) | 1;
    const size_t split = (size_t)2 * K * L.stride * 4;
    const size_t merge = (size_t)2 * V * K * 4;  // aliases `split`
    size_t o = 0;
    L.split = o;
    o += split > merge ? split : merge;  // a multiple of 8
    L.red64 = o;
    o += kWarps * 8;
    L.lanes = o;
    o += (size_t)2 * V * 4;
    L.cpos = o;
    o += (size_t)2 * K * 4;
    L.cstr = o;
    o += (size_t)2 * K * 4;
    L.cval = o;
    o += (size_t)2 * K * 4;
    L.sorted = o;
    o += (size_t)2 * K * 4;
    L.counter = o;  // [0], [1]: merge counts per strand; [2]: contig
    o += 4 * 4;
    L.red = o;
    o += kWarps * 4;
    L.win = o;
    o += kWinFields * 4;
    L.windows = o;
    o += (size_t)2 * K * (Lp + 2);
    L.read = o;
    o += Lp;
    L.rc = o;
    o += Lp;
    L.total = (o + 15) & ~(size_t)15;
    return L;
}

__device__ __forceinline__ int comp(int x) { return x < 4 ? 3 - x : x; }

// The minimum of x over the block (T unsigned or unsigned long long,
// red[kWarps] of scratch); every thread calls it.
template <typename T>
__device__ __forceinline__ T block_min(T x, T* red) {
    for (int o = 16; o > 0; o >>= 1) {
        const T y = __shfl_xor_sync(kFull, x, o);
        x = y < x ? y : x;
    }
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    T r = red[0];
    for (int w = 1; w < kWarps; ++w) r = red[w] < r ? red[w] : r;
    __syncthreads();
    return r;
}

// The k smallest of buf[0:n] (k <= kRankMax, n <= 32 * kThreads),
// ascending with duplicates, into out[0:min(n, k)]. Every thread calls
// it with the same n.
__device__ void select_k(const uint32_t* buf, int n, int k, uint32_t* out,
                         unsigned long long* red) {
    const int tid = threadIdx.x;
    if (n <= kRankMax) {
        for (int e = tid; e < n; e += kThreads) {
            const uint32_t val = buf[e];
            int rank = 0;
            for (int q = 0; q < n && rank < k; ++q) {
                const uint32_t w = buf[q];
                rank += w < val || (w == val && q < e);
            }
            if (rank < k) out[rank] = val;
        }
        return;
    }
    // k rounds: the block minimum of (value, index) over the entries not
    // yet taken; its owner takes it. Bit i of `taken`: entry tid + i *
    // kThreads.
    unsigned taken = 0;
    for (int r = 0; r < k; ++r) {
        unsigned long long mine = ~0ull;
        for (int e = tid, i = 0; e < n; e += kThreads, ++i) {
            const unsigned long long key =
                (unsigned long long)buf[e] << 32 | (unsigned)e;
            if (!((taken >> i) & 1u) && key < mine) mine = key;
        }
        const unsigned long long m = block_min(mine, red);
        const int e = (int)(m & 0xffffffffu);
        if (e % kThreads == tid) taken |= 1u << (e / kThreads);
        if (tid == 0) out[r] = (uint32_t)(m >> 32);
    }
}

// searchsorted(offsets, x, right=True): the offsets <= x.
__device__ __forceinline__ int upper(const int64_t* off, int n,
                                     long long x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (off[mid] <= x)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

__global__ void __launch_bounds__(kThreads)
explore_kernel(const ExploreArgs a) {
    const int b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int Lp = a.Lp, K = a.K, V = a.V, al = a.anchor_len;
    const Layout L = layout(Lp, K, V);
    unsigned char* smem = fc2t_explore_smem;
    int* split = reinterpret_cast<int*>(smem + L.split);
    uint32_t* mbuf = reinterpret_cast<uint32_t*>(smem + L.split);
    unsigned long long* red64 =
        reinterpret_cast<unsigned long long*>(smem + L.red64);
    int* lanes = reinterpret_cast<int*>(smem + L.lanes);
    uint32_t* cpos = reinterpret_cast<uint32_t*>(smem + L.cpos);
    int* cstr = reinterpret_cast<int*>(smem + L.cstr);
    int* cval = reinterpret_cast<int*>(smem + L.cval);
    uint32_t* sorted = reinterpret_cast<uint32_t*>(smem + L.sorted);
    int* counter = reinterpret_cast<int*>(smem + L.counter);
    unsigned* red = reinterpret_cast<unsigned*>(smem + L.red);
    unsigned* win = reinterpret_cast<unsigned*>(smem + L.win);
    uint8_t* windows = smem + L.windows;
    uint8_t* R = smem + L.read;
    uint8_t* RC = smem + L.rc;

    // The read and its left-aligned reverse complement (RPAD past len).
    const int len = a.lens[b];
    const uint8_t* read = a.reads + (size_t)b * Lp;
    for (int p = tid; p < Lp; p += kThreads) {
        R[p] = read[p];
        int src = len - 1 - p;
        src = src < 0 ? 0 : (src > Lp - 1 ? Lp - 1 : src);
        RC[p] = (uint8_t)(p < len ? comp(read[src]) : kRpad);
    }
    if (tid == 0) counter[2] = 0;

    // --- merged_candidates, anchor A then B ------------------------------
    const int V2 = 2 * V;
    for (int x = 0; x < 2; ++x) {
        const ExploreAnchor& an = a.anchor[x];
        const int best = an.mm[b];
        const size_t row = (size_t)b * V2;
        // Each slot's lanes at the best level: min(count, K), else none.
        for (int t = tid; t < V2; t += kThreads) {
            const int c = an.count[row + t];
            lanes[t] = c > 0 && a.mm_v[t] == best ? (c < K ? c : K) : 0;
        }
        if (tid < 2) counter[tid] = 0;
        __syncthreads();
        for (int t0 = 0; t0 < V2 * K; t0 += kThreads * kBatch) {
            uint32_t val[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int t = t0 + u * kThreads + tid;
                const int slot = t / K, l = t - slot * K;
                val[u] = kLargePos;
                if (t < V2 * K && l < lanes[slot])
                    val[u] = (uint32_t)(
                        l == 0 ? an.first_pos[row + slot]
                               : an.extras[(row + slot) * (K - 1) + l - 1]);
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                if (val[u] == kLargePos) continue;
                const int st = (t0 + u * kThreads + tid) / K >= V;
                mbuf[st * V * K + atomicAdd(&counter[st], 1)] = val[u];
            }
        }
        __syncthreads();
        for (int st = 0; st < 2; ++st)
            select_k(mbuf + st * V * K, counter[st], K, sorted + st * K,
                     red64);
        __syncthreads();
        if (tid < K) {
            const int np = counter[0] < K ? counter[0] : K;
            const int nm = counter[1] < K ? counter[1] : K;
            const int c = x * K + tid;
            if (tid < np) {
                cpos[c] = sorted[tid];
                cstr[c] = 0;
                cval[c] = 1;
            } else if (tid < np + nm) {
                cpos[c] = sorted[K + tid - np];
                cstr[c] = 1;
                cval[c] = 1;
            } else {
                cpos[c] = kLargePos;
                cstr[c] = 0;
                cval[c] = 0;
            }
        }
        __syncthreads();
    }

    // --- _candidate_side: one warp per valid candidate -------------------
    const long long max_start = a.nbases - (Lp + 2);
    const int S = L.stride;
    for (int c = warp; c < 2 * K; c += kWarps) {
        if (!cval[c]) continue;
        const int st = cstr[c];
        const bool left = c < K ? st == 0 : st == 1;
        const uint32_t pos = cpos[c];
        const uint32_t start =
            left ? pos : pos + (uint32_t)al - (uint32_t)len - 2u;
        const long long s0 =
            (long long)start < max_start ? (long long)start : max_start;
        uint8_t* w = windows + (size_t)c * (Lp + 2);
        for (int t = lane; t < Lp + 2; t += 32) {
            const long long g = s0 + t;
            const uint32_t word = (uint32_t)a.words[g >> 3];
            w[t] = (uint8_t)((word >> (4 * (int)(g & 7))) & 7u);
        }
        __syncwarp();
        const uint8_t* q = st == 0 ? R : RC;
        const uint8_t* seg = left ? w : w + 2;
        int* row = split + c * S;
        int carry = 0;
        for (int p0 = 0; p0 < Lp; p0 += 32) {
            const int p = p0 + lane;
            int incl = 0;
            if (p < Lp) {
                const int qc = q[p], wc = seg[p];
                incl = (qc != wc || qc >= 4 || wc >= 4) && p < len;
            }
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(kFull, incl, d);
                if (lane >= d) incl += y;
            }
            if (p < Lp) row[p + 1] = carry + incl;  // mismatches in [0, p]
            carry += __shfl_sync(kFull, incl, 31);
        }
        if (lane == 0) {
            row[0] = 0;
            if (carry <= a.prefilter_mm) counter[2] = 1;  // §6 prefilter
        }
        __syncwarp();
        for (int k = lane; k <= Lp; k += 32) {
            const int pf = row[k], w0 = w[k], w1 = w[k + 1];
            int u, f;
            if (left) {
                u = pf;
                f = ((w0 == kG && w1 == kT) << 1) | (w0 == kC && w1 == kT);
            } else {
                u = carry - pf;
                f = ((w0 == kA && w1 == kG) << 1) | (w0 == kA && w1 == kC);
            }
            row[k] = u * 4 + f;
        }
        __syncwarp();
    }
    __syncthreads();

    // --- the K x K pairs, one a thread ----------------------------------
    const bool is_pair = tid < K * K;
    const int i = is_pair ? tid / K : 0;
    const int j = is_pair ? tid - i * K : 0;
    const int s = cstr[i];
    const uint32_t ua = (uint32_t)al;
    // Strand canonicalization [FROZEN] SPEC §3: '-' pairs swap roles.
    const uint32_t pA = s == 0 ? cpos[i] : cpos[K + j];
    const uint32_t pB = s == 0 ? cpos[K + j] : cpos[i];
    const uint32_t endB = pB + ua;
    const bool linear = pA + ua <= pB, circular = endB <= pA;
    const int kind = circular ? kCircular : kLinear;
    bool pair_ok = is_pair && cval[i] && cval[K + j] && s == cstr[K + j] &&
                   (linear || circular);
    int chA = 0;
    if (pair_ok) {
        chA = upper(a.chrom_offsets, a.n_chroms, pA) - 1;
        pair_ok = chA == upper(a.chrom_offsets, a.n_chroms, pB) - 1;
    }
    int edits = kBig, n_bp = 0, kmin = kNoSplit;
    if (pair_ok) {
        const int lo = al, hi = len - al < Lp ? len - al : Lp;
        const int* ra = split + i * S;
        const int* rb = split + (K + j) * S;
        int best = 0x7fffffff, bk = 0, msc = 0x7fffffff, cnt = 0;
        for (int k = lo; k <= hi; ++k) {
            const int x = ra[k], y = rb[k];
            const int sc = (x >> 2) + (y >> 2);
            // (score, !canon+, !canon-) of the frozen split tie-break.
            const int e4 = sc * 4 + 3 - (x & y & 3);
            if (e4 < best) {
                best = e4;
                bk = k;
            }
            if (sc < msc) {
                msc = sc;
                cnt = 1;
            } else if (sc == msc) {
                ++cnt;
            }
        }
        if (lo <= hi) {
            edits = msc;
            n_bp = cnt;
            kmin = best * (Lp + 2) + bk;
        }
    }
    const int best_k = kmin % (Lp + 2), rest = kmin / (Lp + 2);
    const bool cm_b = (rest & 1) == 0, cp_b = ((rest >> 1) & 1) == 0;
    const uint32_t donor = pA + (uint32_t)best_k;
    const uint32_t acceptor = endB + (uint32_t)best_k - (uint32_t)len;
    const uint32_t startj = circular ? acceptor : donor;
    const uint32_t endj = circular ? donor : acceptor;
    pair_ok = pair_ok && !(kind == kLinear && endj <= startj);

    // Frozen pair tie-break (edits, !c+, !c-, pA, pB, s), then the first
    // pair in row-major order, with the plain code's fills.
    const unsigned e1 =
        (unsigned)edits * 4u + (cp_b ? 0u : 2u) + (cm_b ? 0u : 1u);
    bool ok = pair_ok;
    unsigned m = block_min(is_pair ? (ok ? e1 : (unsigned)kBig) : kNone, red);
    ok = ok && e1 == m;
    m = block_min(is_pair ? (ok ? pA : kLargePos) : kNone, red);
    ok = ok && pA == m;
    m = block_min(is_pair ? (ok ? pB : kLargePos) : kNone, red);
    ok = ok && pB == m;
    m = block_min(is_pair ? (ok ? (unsigned)s : 2u) : kNone, red);
    ok = ok && (unsigned)s == m;
    const unsigned first = block_min(ok ? (unsigned)tid : kNone, red);
    const bool any_pair = first != kNone;
    if (any_pair && (unsigned)tid == first) {
        win[wKind] = kind;
        win[wStart] = startj;
        win[wEnd] = endj;
        win[wEdits] = edits;
        win[wNbp] = n_bp;
        win[wK] = best_k;
        win[wS] = s;
        win[wPA] = pA;
        win[wPB] = pB;
        win[wChrom] = chA;
        win[wCp] = cp_b;
        win[wCm] = cm_b;
        win[wI] = i;
        win[wJ] = j;
    }
    __syncthreads();
    const unsigned kind_s = any_pair ? win[wKind] : 0;
    const unsigned start_s = any_pair ? win[wStart] : 0;
    const unsigned end_s = any_pair ? win[wEnd] : 0;
    // Pair-margin rescue [FROZEN v4]: min edits over viable pairs at other
    // (kind, start, end) than the winner.
    unsigned alt = kBig;
    if (a.pair_rescue) {
        const bool diff =
            (unsigned)kind != kind_s || startj != start_s || endj != end_s;
        alt = block_min(
            is_pair ? (pair_ok && diff ? (unsigned)edits : (unsigned)kBig)
                    : kNone,
            red);
    }
    if (tid != 0) return;

    // --- the epilogue: signal, overlap, status chain, qual, the row ------
    const ExploreAnchor& ha = a.anchor[0];
    const ExploreAnchor& hb = a.anchor[1];
    const unsigned edits_s = any_pair ? win[wEdits] : 0;
    const unsigned k_s = any_pair ? win[wK] : 0;
    const unsigned s_s = any_pair ? win[wS] : 0;
    const uint32_t pA_s = any_pair ? win[wPA] : 0;
    const uint32_t pB_s = any_pair ? win[wPB] : 0;
    const bool cp_s = any_pair && win[wCp];
    const bool cm_s = any_pair && win[wCm];
    int d0 = 0, d1 = 0, a0 = 0, a1 = 0;
    if (any_pair) {
        const uint8_t* wa = windows + (size_t)win[wI] * (Lp + 2);
        const uint8_t* wb = windows + (size_t)(K + win[wJ]) * (Lp + 2);
        const uint8_t* wl = s_s == 0 ? wa : wb;
        const uint8_t* wr = s_s == 0 ? wb : wa;
        const int k0 = (int)k_s < Lp + 1 ? (int)k_s : Lp + 1;
        const int k1 = (int)k_s + 1 < Lp + 1 ? (int)k_s + 1 : Lp + 1;
        d0 = wl[k0];
        d1 = wl[k1];
        a0 = wr[k0];
        a1 = wr[k1];
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
    const uint32_t posa = (uint32_t)ha.pos[b], posb = (uint32_t)hb.pos[b];
    const int sa = ha.strand[b], sb = hb.strand[b];
    const bool minus1 = sa == 1;
    const uint32_t pA1 = minus1 ? posb : posa, pB1 = minus1 ? posa : posb;
    const bool geom1 = pA1 + ua <= pB1 || pB1 + ua <= pA1;
    int status =
        sa != sb ? kDiffStrand
        : upper(a.chrom_offsets, a.n_chroms, posa) !=
                upper(a.chrom_offsets, a.n_chroms, posb)
            ? kDiffChrom
            : (geom1 ? kNoJunction : kAnchorOverlap);
    if (any_pair) status = kJunction;
    if (!hb.aligned[b]) status = kUnalignedB;
    if (!ha.aligned[b]) status = kUnalignedA;
    if (a.prefilter && counter[2]) status = kPrefiltered;

    int ql = s_s == 0 ? ha.qual[b] : hb.qual[b];
    int qr = s_s == 0 ? hb.qual[b] : ha.qual[b];
    if (a.pair_rescue) {
        const int margin =
            alt >= (unsigned)kBig ? al + 1 : (int)alt - (int)edits_s;
        const bool multi = ha.n_best[b] > 1 || hb.n_best[b] > 1;
        const int rq = any_pair && multi && margin > 0
                           ? (10 * margin < 40 ? 10 * margin : 40)
                           : 0;
        ql = ql > rq ? ql : rq;
        qr = qr > rq ? qr : rq;
    }
    int32_t* o = a.out + (size_t)b * kPackFields;
    o[0] = status;
    o[1] = (int)kind_s;
    o[2] = any_pair ? (int)win[wChrom] : 0;
    o[3] = (int)start_s;
    o[4] = (int)end_s;
    o[5] = sense;
    o[6] = (int)s_s;
    o[7] = (int)edits_s;
    o[8] = any_pair ? (int)win[wNbp] : 0;
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
    if (a->K < 1 || a->K > kMaxK || a->Lp < 1 || a->V < 1 ||
        a->V * a->K > 32 * kThreads)
        return -(int)cudaErrorInvalidValue;
    int dev = -1;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -(int)err;
    if (dev != a->device) return -(int)cudaErrorInvalidDevice;
    const size_t smem_bytes = layout(a->Lp, a->K, a->V).total;
    if (smem_bytes > 48 * 1024) {
        err = cudaFuncSetAttribute(explore_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes);
        if (err != cudaSuccess) return -(int)err;
    }
    explore_kernel<<<(unsigned)a->B, kThreads, smem_bytes,
                     static_cast<cudaStream_t>(a->stream)>>>(*a);
    err = cudaGetLastError();
    return err == cudaSuccess ? 1 : -(int)err;
}
