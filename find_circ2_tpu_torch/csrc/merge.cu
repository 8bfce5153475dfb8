// K-h, the junction merge: a stable sort of the junction rows on their
// key, then a sum, maximum or minimum of eight fields over each run of
// equal keys, with the runs' heads packed first. The rows are cut into
// tiles of kTile; three kernels, each a block a tile, spread the work
// over the SMs: merge_tiles sorts each tile, merge_rank places every row
// by its rank across the tiles, merge_combine reduces the runs. Up to
// kTile rows the one tile is already the sorted order and merge_rank is
// not launched. No CUB, Thrust or library sort.
//
// Replaces the plain _sort_combine of find_circ2_tpu_torch/ops/merge.py
// under merge_junctions (its table built from a detect result: live,
// uniq, strand match) and merge_tables: four stable argsort passes,
// fourteen row gathers, a cumsum, a scatter of the heads and eight
// scatter_reduce calls. The reference computes the same as one XLA
// program, not Pallas (find_circ2_tpu/ops/merge.py:36 _sort_combine,
// :98 merge_junctions, :125 merge_tables).
//
// What bounds it on this card: neither bytes nor operations but latency.
// Its columns in and out are about 125 bytes a row (2,048 rows: 0.26 MB,
// under a tenth of a microsecond at 3.35 TB/s), and N log2 N key
// comparisons and a combine a row are 6.2 million int32 operations at
// 16,384 rows, under a tenth of a microsecond too. What is left is
// the chain each block waits on (its round trips to L2 and device
// memory, its barriers, the look-back) and each kernel's own start, a
// fixed cost a kernel. So each block's chain is a few round trips, as
// many chains run at once as there are tiles, no step grows with log N,
// and the second and third kernels start while the one before them ends
// (programmatic dependent launch):
//
//  - merge_tiles (a block a tile of kTile rows, kParts threads a row):
//    the row's record (its raw key fields, live, and the eight values,
//    merge_junctions' table built here; every column loaded at once) and
//    its key, the reference's masked fields (a dead row has k_hi 1 << 24
//    and start, end and sense 0) as two 64-bit words, (k_hi with its sign
//    flipped, start) and (end, sense with its sign flipped), so that
//    unsigned order is the key's order. Its place in the tile is the
//    count of the tile's keys below it, kParts threads each counting a
//    share from shared memory, every lane of a warp reading the same key
//    (a broadcast, no bank conflict); equal keys count where their rows
//    come first, so the order is the stable one with no row index in the
//    key. Key, record and rank go straight to that place.
//  - merge_rank (a block a tile A and a group of the other tiles, when
//    there are two tiles or more): a row of A lands at its place in A
//    plus, for every other tile B, the number of B's keys below its key,
//    a binary search of log2 kTile + 1 steps in B's sorted keys staged in
//    shared memory. Tiles hold consecutive rows, so equal keys count when
//    B comes before A. The ranks are a permutation, the stable order
//    exactly. Each group adds its counts to the ranks (red.add); the
//    group that finishes A last (one acquire-release atomic a block)
//    writes A's records to their ranks, so the sorted rows are written
//    once and contiguous, and the combine reads them in order.
//  - merge_combine (a block a tile of the sorted rows, in the order of
//    the blocks' indices, which the look-back relies on as CUB's scans
//    do): heads from each row and the row before it (a shuffle; lane 0
//    reads it), the block's scan of the heads, and the heads before the
//    tile by a decoupled look-back over the tiles' published counts, 32
//    tiles a read. Runs of lanes in one segment reduce in the warp and
//    into the tile's segments in shared memory; a segment inside the
//    tile is stored, one that crosses a tile edge takes integer atomics
//    on the identities merge_tiles wrote (sums, maxima and minima do not
//    depend on their order). Each tile also writes its share of the fill
//    rows, counted back from N - 1, so no block waits for the total.
//
// Kept bit for bit, against the plain version, on all N output rows: a
// dead row's segment is N - 1, so with dead rows segment N - 1 has sum
// 0, minimum 2^30 (BIGDEF) and maximum 0; other empty segments keep the
// identities (sum 0, minimum INT32_MAX, maximum INT32_MIN); fill rows
// past the heads take their key fields from the last sorted row; k_hi is
// the reference's int32 kind * 2^16 + chrom; start and end sort as
// uint32 and come out as the int64 they came in.
//
// Plain C interface for ctypes: one packed argument buffer (MergeArgs)
// and a scratch buffer of fc2t_merge_scratch_bytes(n) bytes. The entry
// returns the kernels it launched (2 up to kTile rows, 3 above), or
// minus a CUDA error.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

// The arguments of one merge, packed by ops/merge.py into one buffer.
// Table mode (valid != nullptr): the rows are a table of ops/merge's
// ALL_FIELDS. Result mode (valid == nullptr): they are a detect result,
// the table built as merge_junctions builds it (the sum fields' pointers
// null, the maximum fields qual_left and qual_right).
struct MergeArgs {
    const uint8_t* valid;          // [n] bool, or null (result mode)
    const int32_t* kind;           // [n]
    const int32_t* chrom;          // [n]
    const int64_t* start;          // [n], uint32 values
    const int64_t* end;            // [n], uint32 values
    const int32_t* sense;          // [n]
    const int32_t* sums[3];        // n_reads, uniq_bridges, n_strand_match
    const int32_t* maxs[2];        // best_qual_left, best_qual_right
    const int32_t* mins[3];        // edits, overlap, n_bp
    const int32_t* status;         // result mode: [n]
    const int32_t* lens;           // result mode: [n]
    const int32_t* multi;          // result mode: [n], or null
    const int32_t* align_strand;   // result mode: [n]
    uint8_t* o_valid;              // the merged table [n], ALL_FIELDS' order
    int32_t* o_kind;
    int32_t* o_chrom;
    int64_t* o_start;
    int64_t* o_end;
    int32_t* o_sense;
    int32_t* o_sums[3];
    int32_t* o_maxs[2];
    int32_t* o_mins[3];
    void* scratch;                 // fc2t_merge_scratch_bytes(n), 16-aligned
    void* stream;
    long long n;
    long long scratch_bytes;
    int st_junction, min_uniq_qual, device, reserved;
};
static_assert(sizeof(MergeArgs) == 304, "layout packed by ops/merge");

namespace {

// Rows a tile; threads a block of merge_rank and merge_combine.
constexpr int kTile = 128;
constexpr int kWarps = kTile / 32;
// merge_tiles' threads a row, each counting a share of the tile's keys.
constexpr int kParts = 4;
// The most blocks that rank one tile (merge_rank's groups).
constexpr int kMaxGroups = 32;
constexpr unsigned kFull = 0xffffffffu;
// ops/merge.py's constants: the dead rows' k_hi and minimum.
constexpr int32_t kDeadHi = 1 << 24;
constexpr int32_t kBigDef = 1 << 30;
constexpr int kSums = 3, kMaxs = 2, kMins = 3, kVals = 8;
// A tile's published head count in the look-back: the status in the top
// two bits (0: none yet), the count below.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kCount = kAggregate - 1;

}  // namespace

// Built with FC2T_MERGE_STAMPS (ops/merge.merge_stage_cycles): a row of
// kMergeStamps clocks a tile in fc2t_mstamps, each stage's start and end
// on one SM's clock64, by thread 0 after a barrier: load and key build,
// tile sort (merge_tiles' block of tile A), rank and scatter
// (merge_rank's), combine (merge_combine's block of sorted tile A).
// Without it, MSTAMP is nothing.
#ifdef FC2T_MERGE_STAMPS
constexpr int kMergeStamps = 10;
__device__ unsigned long long* fc2t_mstamps = nullptr;
__device__ __forceinline__ void merge_stamp(long long row, int col,
                                            unsigned long long clk) {
    volatile unsigned long long* p = fc2t_mstamps;
    if (p) p[row * kMergeStamps + col] = clk;
}
#define MCLOCK(var) const unsigned long long var = clock64()
#define MSTAMP(row, col, clk) merge_stamp((row), (col), (clk))
#else
#define MCLOCK(var) \
    do {            \
    } while (0)
#define MSTAMP(row, col, clk) \
    do {                      \
    } while (0)
#endif

namespace {

// A row as the combine reads it: its raw key fields, live, and its eight
// values as merge_junctions' table holds them.
struct Rec {
    int32_t kind, chrom, sense, live;
    long long start, end;
    int32_t v[kVals];
};

// A record in memory: four 16-byte words, (kind, chrom, sense, live),
// (start, end), then the values.
struct __align__(16) RecMem {
    int4 w[4];
};

// The scratch buffer, carved by carve().
struct Scratch {
    ulonglong2* keys;             // [n] each tile's sorted (hi, lo)
    RecMem* rec_tile;             // [n] each tile's records, sorted in it
    RecMem* rec_sorted;           // [n] every record at its rank
    uint32_t* rank;               // [n] the rank of each tile's k-th row
    unsigned long long* state;    // [tiles] the look-back's head counts
    uint32_t* done;               // [tiles] merge_rank's groups finished
    uint32_t* dead;               // [tiles] the tile holds a dead row
};

__host__ __device__ constexpr size_t up256(size_t x) {
    return (x + 255) & ~size_t(255);
}

// The scratch bytes of n rows, and where each part lies.
__host__ size_t carve(long long n, char* base, Scratch* s) {
    constexpr int kNumParts = 7;
    const long long tiles = (n + kTile - 1) / kTile;
    const size_t parts[kNumParts] = {
        up256(sizeof(ulonglong2) * n), up256(sizeof(RecMem) * n),
        up256(sizeof(RecMem) * n),     up256(4 * (size_t)n),
        up256(8 * (size_t)tiles),      up256(4 * (size_t)tiles),
        up256(4 * (size_t)tiles)};
    size_t at[kNumParts], total = 0;
    for (int i = 0; i < kNumParts; ++i) {
        at[i] = total;
        total += parts[i];
    }
    if (s) {
        s->keys = reinterpret_cast<ulonglong2*>(base + at[0]);
        s->rec_tile = reinterpret_cast<RecMem*>(base + at[1]);
        s->rec_sorted = reinterpret_cast<RecMem*>(base + at[2]);
        s->rank = reinterpret_cast<uint32_t*>(base + at[3]);
        s->state = reinterpret_cast<unsigned long long*>(base + at[4]);
        s->done = reinterpret_cast<uint32_t*>(base + at[5]);
        s->dead = reinterpret_cast<uint32_t*>(base + at[6]);
    }
    return total;
}

// Every column is read whatever the others hold, so that the loads go
// out together (a short-circuit would chain them).
__device__ __forceinline__ bool row_live(const MergeArgs& a, long long r) {
    if (a.valid) return a.valid[r] != 0;
    const int32_t st = a.status[r], len = a.lens[r];
    const int32_t multi = a.multi ? a.multi[r] : 0;
    return (st == a.st_junction) & (len > 0) & (multi == 0);
}

// Programmatic dependent launch: let the next kernel's blocks start, and
// wait until the kernel before this one has finished and its writes are
// visible (a no-op when it was launched without the attribute).
__device__ __forceinline__ void launch_next() {
    asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void wait_prior() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Row r's record. A dead row's values are the plain version's
// where(s_live, x, dead): 0 for the sums and maxima, BIGDEF for the
// minima.
__device__ __forceinline__ Rec load_rec(const MergeArgs& a, long long r) {
    Rec x;
    x.live = row_live(a, r);
    x.kind = a.kind[r];
    x.chrom = a.chrom[r];
    x.sense = a.sense[r];
    x.start = a.start[r];
    x.end = a.end[r];
    if (a.valid) {
#pragma unroll
        for (int f = 0; f < kSums; ++f) x.v[f] = a.sums[f][r];
    } else {
        const int32_t ql = a.maxs[0][r], qr = a.maxs[1][r];
        x.v[0] = 1;
        x.v[1] = ql >= a.min_uniq_qual && qr >= a.min_uniq_qual;
        x.v[2] = a.align_strand[r] == x.sense;
    }
#pragma unroll
    for (int f = 0; f < kMaxs; ++f) x.v[kSums + f] = a.maxs[f][r];
#pragma unroll
    for (int f = 0; f < kMins; ++f) x.v[kSums + kMaxs + f] = a.mins[f][r];
    if (!x.live) {
#pragma unroll
        for (int f = 0; f < kSums + kMaxs; ++f) x.v[f] = 0;
#pragma unroll
        for (int f = kSums + kMaxs; f < kVals; ++f) x.v[f] = kBigDef;
    }
    return x;
}

// The sort key of a record: (k_hi, start) and (end, sense) on the masked
// fields, each signed field with its sign bit flipped so that unsigned
// order is its order.
__device__ __forceinline__ void rec_key(const Rec& x, unsigned long long& hi,
                                        unsigned long long& lo) {
    const uint32_t k_hi =
        x.live ? (uint32_t)x.kind * 65536u + (uint32_t)x.chrom
               : (uint32_t)kDeadHi;
    const uint32_t ks = x.live ? (uint32_t)x.start : 0u;
    const uint32_t ke = x.live ? (uint32_t)x.end : 0u;
    const uint32_t kse = x.live ? (uint32_t)x.sense : 0u;
    hi = (unsigned long long)(k_hi ^ 0x80000000u) << 32 | ks;
    lo = (unsigned long long)ke << 32 | (kse ^ 0x80000000u);
}

__device__ __forceinline__ void put_rec(RecMem* p, const Rec& x) {
    p->w[0] = make_int4(x.kind, x.chrom, x.sense, x.live);
    p->w[1] = make_int4((int)x.start, (int)(x.start >> 32), (int)x.end,
                        (int)(x.end >> 32));
    p->w[2] = make_int4(x.v[0], x.v[1], x.v[2], x.v[3]);
    p->w[3] = make_int4(x.v[4], x.v[5], x.v[6], x.v[7]);
}

__device__ __forceinline__ long long join64(int lo, int hi) {
    return (long long)((unsigned long long)(unsigned)hi << 32 |
                       (unsigned)lo);
}

// Two rows' raw key fields equal (the plain version's `same`, before
// liveness): words (kind, chrom, sense, -) and (start, end).
__device__ __forceinline__ bool same_raw(int4 a0, int4 a1, int4 b0,
                                         int4 b1) {
    return a0.x == b0.x && a0.y == b0.y && a0.z == b0.z && a1.x == b1.x &&
           a1.y == b1.y && a1.z == b1.z && a1.w == b1.w;
}

__device__ __forceinline__ bool pair_less(ulonglong2 a, ulonglong2 b) {
    return a.x != b.x ? a.x < b.x : a.y < b.y;
}

__device__ __forceinline__ int32_t identity(int f) {
    return f < kSums ? 0 : f < kSums + kMaxs ? INT_MIN : INT_MAX;
}

// Each tile's rows: their records, their keys and their places in the
// tile, each the count of the tile's keys below its own (equal keys
// count where their rows come first, so the order is stable), kParts
// threads a row each counting a share from shared memory, every lane of
// a warp on the same key (a broadcast); then the keys, records and
// ranks written at their places, the identities of the tile's output
// rows' values, and the tile's bookkeeping zeroed.
__global__ void __launch_bounds__(kParts * kTile)
merge_tiles(const __grid_constant__ MergeArgs a, const Scratch s) {
    __shared__ ulonglong2 sh_key[kTile];
    __shared__ int sh_part[kParts][kTile];
    launch_next();
    MCLOCK(c0);
    const int t = threadIdx.x % kTile, part = threadIdx.x / kTile;
    const long long base = (long long)blockIdx.x * kTile;
    const long long r = base + t;
    const bool in = r < a.n;
    Rec rec;
    // Past n: the largest key, below no row's.
    ulonglong2 x = make_ulonglong2(~0ull, ~0ull);
    if (part == 0) {
        if (in) {
            rec = load_rec(a, r);
            rec_key(rec, x.x, x.y);
#pragma unroll
            for (int f = 0; f < kSums; ++f) a.o_sums[f][r] = 0;
#pragma unroll
            for (int f = 0; f < kMaxs; ++f) a.o_maxs[f][r] = INT_MIN;
#pragma unroll
            for (int f = 0; f < kMins; ++f) a.o_mins[f][r] = INT_MAX;
        }
        sh_key[t] = x;
    }
    if (threadIdx.x == 0) {
        s.state[blockIdx.x] = 0;
        s.done[blockIdx.x] = 0;
    }
    const int dead = __syncthreads_or(part == 0 && in && !rec.live);
    if (threadIdx.x == 0) s.dead[blockIdx.x] = dead;
    MCLOCK(c1);
    x = sh_key[t];
    int below[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < kTile / kParts; ++k) {
        const int j = part * (kTile / kParts) + k;
        const ulonglong2 y = sh_key[j];
        const bool lt = (y.x < x.x) | ((y.x == x.x) & (y.y < x.y));
        const bool eq = (y.x == x.x) & (y.y == x.y);
        below[k & 3] += lt | (eq & (j < t));
    }
    sh_part[part][t] = below[0] + below[1] + below[2] + below[3];
    __syncthreads();
    if (part == 0 && in) {
        int place = 0;
#pragma unroll
        for (int q = 0; q < kParts; ++q) place += sh_part[q][t];
        s.keys[base + place] = x;
        s.rank[base + place] = place;
        put_rec(s.rec_tile + base + place, rec);
    }
#ifdef FC2T_MERGE_STAMPS
    __syncthreads();
    if (threadIdx.x == 0) {
        MSTAMP(blockIdx.x, 0, c0);
        MSTAMP(blockIdx.x, 1, c1);
        MSTAMP(blockIdx.x, 2, c1);
        MSTAMP(blockIdx.x, 3, clock64());
    }
#endif
}

// Rank tile A's rows against group g's tiles (every groups-th tile from
// g, but A): for each such tile B, the count of B's keys below the row's
// key (equal keys too where B comes first), a binary search of log2
// kTile + 1 steps in B's sorted keys staged in shared memory, added to
// the row's rank. The group that finishes A last (a counter a tile,
// taken with acquire-release order after the block's barrier) writes
// A's records to their ranks.
__global__ void __launch_bounds__(kTile)
merge_rank(const __grid_constant__ MergeArgs a, const Scratch s,
           int tiles, int groups) {
    __shared__ ulonglong2 sh_key[kTile];
    __shared__ bool sh_last;
    launch_next();
    wait_prior();
    MCLOCK(c0);
    const int t = threadIdx.x;
    const int A = blockIdx.x, g = blockIdx.y;
    const long long n = a.n;
    const long long base = (long long)A * kTile;
    const int count = (int)(n - base < kTile ? n - base : kTile);
    const bool in = t < count;
    const ulonglong2 x = in ? s.keys[base + t] : make_ulonglong2(0, 0);
    uint32_t below = 0;
    for (int b = g; b < tiles; b += groups) {
        if (b == A) continue;
        const long long bbase = (long long)b * kTile;
        const int bcount = (int)(n - bbase < kTile ? n - bbase : kTile);
        __syncthreads();
        if (t < bcount) sh_key[t] = s.keys[bbase + t];
        __syncthreads();
        const bool earlier = b < A;
        int pos = 0;
#pragma unroll
        for (int step = kTile; step > 0; step >>= 1) {
            if (pos + step <= bcount) {
                const ulonglong2 y = sh_key[pos + step - 1];
                if (earlier ? !pair_less(x, y) : pair_less(y, x))
                    pos += step;
            }
        }
        below += pos;
    }
    if (in && below) atomicAdd(s.rank + base + t, below);
    __syncthreads();
    if (t == 0) {
        unsigned prev;
        asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                     : "=r"(prev)
                     : "l"(s.done + A)
                     : "memory");
        sh_last = prev == (unsigned)groups - 1;
    }
    __syncthreads();
    if (!sh_last) return;
    MCLOCK(c1);
    if (in) {
        const uint32_t rank = __ldcg(s.rank + base + t);
        const RecMem* src = s.rec_tile + base + t;
        RecMem* dst = s.rec_sorted + rank;
#pragma unroll
        for (int q = 0; q < 4; ++q) dst->w[q] = src->w[q];
    }
#ifdef FC2T_MERGE_STAMPS
    __syncthreads();
    if (t == 0) {
        MSTAMP(A, 4, c0);
        MSTAMP(A, 5, c1);
        MSTAMP(A, 6, c1);
        MSTAMP(A, 7, clock64());
    }
#endif
}

// The heads before tile c by a decoupled look-back, warp 0 of its block:
// publish the tile's own count, then read 32 tiles before it at once
// until one holds its inclusive count; publish the inclusive count.
__device__ long long look_back(unsigned long long* state, long long c,
                               int total, int lane) {
    volatile unsigned long long* st = state;
    if (c == 0) {
        if (lane == 0) st[0] = kInclusive | (unsigned long long)total;
        return 0;
    }
    if (lane == 0) st[c] = kAggregate | (unsigned long long)total;
    long long before = 0;
    for (long long top = c - 1;; top -= 32) {
        const long long j = top - lane;
        unsigned long long v = kInclusive;  // before tile 0: an inclusive 0
        if (j >= 0) {
            do {
                v = st[j];
            } while ((v >> 62) == 0);
        }
        const unsigned incl = __ballot_sync(kFull, (v >> 62) == 2);
        const int stop = incl ? __ffs(incl) - 1 : 31;
        long long mine = lane <= stop ? (long long)(v & kCount) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            mine += __shfl_xor_sync(kFull, mine, o);
        before += mine;
        if (incl) break;
    }
    if (lane == 0) st[c] = kInclusive | (unsigned long long)(before + total);
    return before;
}

// The combine over the sorted records, a tile a block, in the order of
// the blocks' indices (as the look-back needs, the order the card starts
// them in): heads, segments, the eight reductions, the heads' rows and
// the tile's share of the fill rows. Every load is issued first.
__global__ void __launch_bounds__(kTile)
merge_combine(const __grid_constant__ MergeArgs a, const Scratch s,
              const RecMem* __restrict__ sorted, int tiles) {
    __shared__ int sh_warp[kWarps];
    __shared__ long long sh_before;
    __shared__ int sh_total, sh_first_cont, sh_last_cont;
    // The tile's segments' values: 0 the segment continued from the
    // tile before, k the k-th head's.
    __shared__ int32_t acc[kVals][kTile + 1];
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
#pragma unroll
    for (int f = 0; f < kVals; ++f)
        for (int x = t; x <= kTile; x += kTile) acc[f][x] = identity(f);
    wait_prior();
    MCLOCK(c0);
    const long long n = a.n;
    const long long c = blockIdx.x;
    const long long base = c * kTile;
    const int rows = (int)(n - base < kTile ? n - base : kTile);
    const long long i = base + t;
    const bool in = t < rows;
    int4 k0 = make_int4(0, 0, 0, 0), k1 = k0, v0 = k0, v1 = k0;
    // Lane 0: the row before; the tile's last row: the row after (zero,
    // so not live, past n).
    int4 b0 = k0, b1 = k0, f0 = k0, f1 = k0;
    if (in) {
        k0 = sorted[i].w[0];
        k1 = sorted[i].w[1];
        v0 = sorted[i].w[2];
        v1 = sorted[i].w[3];
        if (lane == 0 && i > 0) {
            b0 = sorted[i - 1].w[0];
            b1 = sorted[i - 1].w[1];
        }
        if (t == rows - 1 && i + 1 < n) {
            f0 = sorted[i + 1].w[0];
            f1 = sorted[i + 1].w[1];
        }
    }
    const int4 e0 = sorted[n - 1].w[0], e1 = sorted[n - 1].w[1];
    int dead = 0;
    for (int x = t; x < tiles; x += kTile) dead |= s.dead[x];
    // The row before: the lane before's, or memory for lane 0.
    int4 p0, p1;
    p0.x = __shfl_up_sync(kFull, k0.x, 1);
    p0.y = __shfl_up_sync(kFull, k0.y, 1);
    p0.z = __shfl_up_sync(kFull, k0.z, 1);
    p0.w = __shfl_up_sync(kFull, k0.w, 1);
    p1.x = __shfl_up_sync(kFull, k1.x, 1);
    p1.y = __shfl_up_sync(kFull, k1.y, 1);
    p1.z = __shfl_up_sync(kFull, k1.z, 1);
    p1.w = __shfl_up_sync(kFull, k1.w, 1);
    if (lane == 0) {
        p0 = b0;
        p1 = b1;
    }
    const bool live = in && k0.w != 0;
    const bool head =
        live && !(i > 0 && p0.w != 0 && same_raw(k0, k1, p0, p1));
    const unsigned ballot = __ballot_sync(kFull, head);
    const int incl_w = __popc(ballot & ((2u << lane) - 1u));
    if (lane == 0) sh_warp[w] = __popc(ballot);
    if (t == 0) sh_first_cont = live && !head;
    // Whether the tile's last segment goes on into the next tile.
    if (t == rows - 1)
        sh_last_cont = live && f0.w != 0 && same_raw(f0, f1, k0, k1);
    __syncthreads();
    // Warp 0: the block's scan of the warps' heads, then the heads before
    // the tile from the look-back.
    if (w == 0) {
        const int x = lane < kWarps ? sh_warp[lane] : 0;
        int sum = x;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(kFull, sum, o);
            if (lane >= o) sum += y;
        }
        const int total = __shfl_sync(kFull, sum, 31);
        if (lane < kWarps) sh_warp[lane] = sum - x;
        const long long before = look_back(s.state, c, total, lane);
        if (lane == 0) {
            sh_before = before;
            sh_total = total;
        }
    }
    __syncthreads();
    const long long before = sh_before;
    const int total = sh_total;
    const int ls = sh_warp[w] + incl_w;  // the row's segment in the tile
    if (head) {
        const long long seg = before + ls - 1;
        a.o_valid[seg] = 1;
        a.o_kind[seg] = k0.x;
        a.o_chrom[seg] = k0.y;
        a.o_sense[seg] = k0.z;
        a.o_start[seg] = join64(k1.x, k1.y);
        a.o_end[seg] = join64(k1.z, k1.w);
    }
    // Each run of lanes in one segment reduces to its first lane, which
    // folds it into the tile's segment.
    int32_t v[kVals] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    const int key = live ? ls : -1;
    const int up = __shfl_up_sync(kFull, key, 1);
    const unsigned starts = __ballot_sync(kFull, lane == 0 || up != key);
    const unsigned above = starts & ~((2u << lane) - 1u);
    const int last = above ? __ffs(above) - 2 : 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int f = 0; f < kVals; ++f) {
            const int32_t y = __shfl_down_sync(kFull, v[f], o);
            if (lane + o <= last)
                v[f] = f < kSums          ? v[f] + y
                       : f < kSums + kMaxs ? max(v[f], y)
                                          : min(v[f], y);
        }
    }
    if (key >= 0 && (starts >> lane & 1u)) {
#pragma unroll
        for (int f = 0; f < kSums; ++f) atomicAdd(&acc[f][key], v[f]);
#pragma unroll
        for (int f = kSums; f < kSums + kMaxs; ++f)
            atomicMax(&acc[f][key], v[f]);
#pragma unroll
        for (int f = kSums + kMaxs; f < kVals; ++f)
            atomicMin(&acc[f][key], v[f]);
    }
    __syncthreads();
    // The tile's segments: stored, or atomics where one crosses an edge.
    const bool first_cont = sh_first_cont, last_cont = sh_last_cont;
    for (int x = t; x <= total; x += kTile) {
        if (x == 0 && !first_cont) continue;
        const long long g = before + x - 1;
        if (x == 0 || (x == total && last_cont)) {
#pragma unroll
            for (int f = 0; f < kSums; ++f) atomicAdd(a.o_sums[f] + g, acc[f][x]);
#pragma unroll
            for (int f = 0; f < kMaxs; ++f)
                atomicMax(a.o_maxs[f] + g, acc[kSums + f][x]);
#pragma unroll
            for (int f = 0; f < kMins; ++f)
                atomicMin(a.o_mins[f] + g, acc[kSums + kMaxs + f][x]);
        } else {
#pragma unroll
            for (int f = 0; f < kSums; ++f) a.o_sums[f][g] = acc[f][x];
#pragma unroll
            for (int f = 0; f < kMaxs; ++f) a.o_maxs[f][g] = acc[kSums + f][x];
#pragma unroll
            for (int f = 0; f < kMins; ++f)
                a.o_mins[f][g] = acc[kSums + kMaxs + f][x];
        }
    }
    // The fill rows, counted back from n - 1: the tile's rows that are
    // not heads, after those of the tiles before it. Their values keep
    // merge_tiles' identities, but for row n - 1 with dead rows.
    const long long kept = base - before;  // non-heads before the tile
    const int fill = rows - total;
    for (int k = t; k < fill; k += kTile) {
        const long long g = n - 1 - kept - k;
        a.o_valid[g] = 0;
        a.o_kind[g] = e0.x;
        a.o_chrom[g] = e0.y;
        a.o_sense[g] = e0.z;
        a.o_start[g] = join64(e1.x, e1.y);
        a.o_end[g] = join64(e1.z, e1.w);
    }
    if (fill > 0 && kept == 0 && __syncthreads_or(dead) && t == 0) {
#pragma unroll
        for (int f = 0; f < kSums; ++f) a.o_sums[f][n - 1] = 0;
#pragma unroll
        for (int f = 0; f < kMaxs; ++f) a.o_maxs[f][n - 1] = 0;
#pragma unroll
        for (int f = 0; f < kMins; ++f) a.o_mins[f][n - 1] = kBigDef;
    }
#ifdef FC2T_MERGE_STAMPS
    __syncthreads();
    if (t == 0) {
        MSTAMP(c, 8, c0);
        MSTAMP(c, 9, clock64());
    }
#endif
}

}  // namespace

// Host side: the C entries.

// The scratch bytes fc2t_merge wants for n rows.
extern "C" long long fc2t_merge_scratch_bytes(long long n) {
    return n <= 0 ? 0 : (long long)carve(n, nullptr, nullptr);
}

// The merged table of the n rows.
extern "C" int fc2t_merge(const MergeArgs* a) {
    if (a->n <= 0) return 0;
    const bool table = a->valid != nullptr;
    bool given = a->kind && a->chrom && a->start && a->end && a->sense &&
                 a->o_valid && a->o_kind && a->o_chrom && a->o_start &&
                 a->o_end && a->o_sense && a->scratch;
    for (int f = 0; f < kSums; ++f)
        given = given && (table == (a->sums[f] != nullptr)) && a->o_sums[f];
    for (int f = 0; f < kMaxs; ++f) given = given && a->maxs[f] && a->o_maxs[f];
    for (int f = 0; f < kMins; ++f) given = given && a->mins[f] && a->o_mins[f];
    if (!table) given = given && a->status && a->lens && a->align_strand;
    if (!given || a->n > (1ll << 31) - 1 ||
        reinterpret_cast<uintptr_t>(a->scratch) % 16 != 0 ||
        a->scratch_bytes < fc2t_merge_scratch_bytes(a->n))
        return -(int)cudaErrorInvalidValue;
    int dev = -1;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -(int)err;
    if (dev != a->device) return -(int)cudaErrorInvalidDevice;
    Scratch s;
    carve(a->n, static_cast<char*>(a->scratch), &s);
    const int tiles = (int)((a->n + kTile - 1) / kTile);
    const int groups = tiles < kMaxGroups ? tiles : kMaxGroups;
    const cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
    merge_tiles<<<tiles, kParts * kTile, 0, stream>>>(*a, s);
    // merge_rank and merge_combine start while the kernel before them
    // ends (programmatic dependent launch); each waits for it first.
    cudaLaunchAttribute early;
    early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    early.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.blockDim = dim3(kTile);
    cfg.stream = stream;
    cfg.attrs = &early;
    cfg.numAttrs = 1;
    if (tiles > 1) {
        cfg.gridDim = dim3(tiles, groups);
        err = cudaLaunchKernelEx(&cfg, merge_rank, *a, s, tiles, groups);
        if (err != cudaSuccess) return -(int)err;
    }
    cfg.gridDim = dim3(tiles);
    const RecMem* sorted = tiles > 1 ? s.rec_sorted : s.rec_tile;
    err = cudaLaunchKernelEx(&cfg, merge_combine, *a, s, sorted, tiles);
    if (err != cudaSuccess) return -(int)err;
    err = cudaGetLastError();
    return err == cudaSuccess ? (tiles > 1 ? 3 : 2) : -(int)err;
}

#ifdef FC2T_MERGE_STAMPS
// Where the next launches record their stage clocks (null: nowhere).
extern "C" int fc2t_merge_stamps(void* stamps) {
    unsigned long long* p = static_cast<unsigned long long*>(stamps);
    const cudaError_t err = cudaMemcpyToSymbol(fc2t_mstamps, &p, sizeof p);
    return err == cudaSuccess ? 0 : -(int)err;
}
#endif
