// K-h, the junction merge: a stable sort of the junction rows on their
// key, then a sum, maximum or minimum of eight fields over each run of
// equal keys, with the runs' heads packed first. One block of 1024
// threads sorts up to kOneBlock rows in shared memory and combines them
// in the same launch; more rows sort in chunks of kOneBlock and merge
// across blocks (a bitonic network whose long steps run on device
// memory), then one block combines.
//
// Replaces the plain _sort_combine of find_circ2_tpu_torch/ops/merge.py
// under merge_junctions (its table built from a detect result: live,
// uniq, strand match) and merge_tables: four stable argsort passes,
// fourteen row gathers, a cumsum, a scatter of the heads and eight
// scatter_reduce calls. The reference computes the same as one XLA
// program, not Pallas (find_circ2_tpu/ops/merge.py:36 _sort_combine,
// :98 merge_junctions, :125 merge_tables).
//
// What bounds it on this card: neither bytes nor operations but the
// sort's chain of barriers. N rows move about 60 N bytes (2,048 rows
// are 0.12 MB, under 0.1 microsecond at 3.35 TB/s); the bitonic network
// makes N/2 log2(N) (log2(N) + 1) / 2 compare-exchanges of a 160-bit key
// (2,048 rows: 67,584), a microsecond of the SMs' integer rate, but in
// one block they are log2(N) (log2(N) + 1) / 2 steps with a barrier
// each (66 at 2,048 rows). The design keeps each step short:
//
//  - The key of a row is built in the load pass from the detect result
//    or the table (the reference's masked fields: a dead row has k_hi
//    1 << 24 and start, end and sense 0), as two 64-bit words, (k_hi
//    with its sign flipped, start) and (end, sense with its sign
//    flipped), and the row index as a third: every key is distinct, so
//    the bitonic network, which is not stable, gives the stable order.
//  - The keys live in shared memory (20 bytes a row: 8,192 rows are
//    160 KB) as three arrays; each of the 1024 threads takes N / 2048
//    compare-exchanges a step.
//  - The combine walks the sorted rows a tile of 1024 at a time: each
//    thread compares its row's raw key with the row before it (`same`
//    compares the raw fields, as the plain version does), a block scan
//    of the heads gives each row its segment, a warp reduces each run of
//    lanes in one segment with five shuffles a field, and the run's
//    first lane combines it into the output with one atomic a field
//    (integer sums, maxima and minima: the result does not depend on
//    their order).
//
// Kept bit for bit, against the plain version, on all N output rows: a
// dead row's segment is N - 1, so with dead rows segment N - 1 has sum
// 0, minimum 2^30 (BIGDEF) and maximum 0; other empty segments keep the
// identities (sum 0, minimum INT32_MAX, maximum INT32_MIN); fill rows
// past the heads take their key fields from the last sorted row; k_hi is
// the reference's int32 kind * 2^16 + chrom; start and end sort as
// uint32 and come out as the int64 they came in.
//
// Plain C interface for ctypes: one packed argument buffer (MergeArgs).
// The entry returns the kernels it launched (1 up to kOneBlock rows,
// more above), or minus a CUDA error.

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
    // Above kOneBlock rows: the sort's keys and order in device memory,
    // [next power of two of n] each; else null.
    unsigned long long* key_hi;
    unsigned long long* key_lo;
    uint32_t* order;
    void* stream;
    long long n;
    int st_junction, min_uniq_qual, device, reserved;
};
static_assert(sizeof(MergeArgs) == 312, "layout packed by ops/merge");

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// The most rows one block sorts in shared memory: 20 bytes a row.
constexpr int kOneBlock = 8192;
constexpr size_t kKeyBytes = 2 * sizeof(unsigned long long) + sizeof(uint32_t);
constexpr unsigned kFull = 0xffffffffu;
// ops/merge.py's constants: the dead rows' k_hi and minimum, the
// segments' identities.
constexpr int32_t kDeadHi = 1 << 24;
constexpr int32_t kBigDef = 1 << 30;
constexpr int kSums = 3, kMaxs = 2, kMins = 3;
constexpr int kMaxDevices = 64;

struct Row {
    bool live;
    int32_t kind, chrom, sense;
    int64_t start, end;
};

__device__ __forceinline__ bool row_live(const MergeArgs& a, long long r) {
    if (a.valid) return a.valid[r] != 0;
    return a.status[r] == a.st_junction && a.lens[r] > 0 &&
           (a.multi == nullptr || a.multi[r] == 0);
}

__device__ __forceinline__ Row load_row(const MergeArgs& a, long long r) {
    return {row_live(a, r), a.kind[r], a.chrom[r], a.sense[r], a.start[r],
            a.end[r]};
}

// The sort key of a row: (k_hi, start) and (end, sense) on the masked
// fields, each signed field with its sign bit flipped so that unsigned
// order is its order.
__device__ __forceinline__ void row_key(const MergeArgs& a, long long r,
                                        unsigned long long& hi,
                                        unsigned long long& lo) {
    const Row w = load_row(a, r);
    const uint32_t k_hi =
        w.live ? (uint32_t)w.kind * 65536u + (uint32_t)w.chrom
               : (uint32_t)kDeadHi;
    const uint32_t ks = w.live ? (uint32_t)w.start : 0u;
    const uint32_t ke = w.live ? (uint32_t)w.end : 0u;
    const uint32_t kse = w.live ? (uint32_t)w.sense : 0u;
    hi = (unsigned long long)(k_hi ^ 0x80000000u) << 32 | ks;
    lo = (unsigned long long)ke << 32 | (kse ^ 0x80000000u);
}

// The row's eight values as merge_junctions' table holds them, a dead
// row's as the plain version's where(s_live, x, dead): 0 for the sums
// and maxima, BIGDEF for the minima.
__device__ __forceinline__ void row_values(const MergeArgs& a, long long r,
                                           bool live, int32_t v[8]) {
    if (a.valid) {
#pragma unroll
        for (int f = 0; f < kSums; ++f) v[f] = a.sums[f][r];
    } else {
        const int32_t ql = a.maxs[0][r], qr = a.maxs[1][r];
        v[0] = 1;
        v[1] = ql >= a.min_uniq_qual && qr >= a.min_uniq_qual;
        v[2] = a.align_strand[r] == a.sense[r];
    }
#pragma unroll
    for (int f = 0; f < kMaxs; ++f) v[kSums + f] = a.maxs[f][r];
#pragma unroll
    for (int f = 0; f < kMins; ++f) v[kSums + kMaxs + f] = a.mins[f][r];
    if (!live) {
#pragma unroll
        for (int f = 0; f < kSums + kMaxs; ++f) v[f] = 0;
#pragma unroll
        for (int f = kSums + kMaxs; f < 8; ++f) v[f] = kBigDef;
    }
}

__device__ __forceinline__ bool key_less(unsigned long long ha,
                                         unsigned long long la, uint32_t ia,
                                         unsigned long long hb,
                                         unsigned long long lb,
                                         uint32_t ib) {
    return ha != hb ? ha < hb : (la != lb ? la < lb : ia < ib);
}

// One step (k, j) of the bitonic network on `count` keys whose first has
// the global index `base`, by the block: element x and x + j are put in
// order, ascending where bit k of x's global index is 0.
__device__ __forceinline__ void bitonic_step(unsigned long long* hi,
                                             unsigned long long* lo,
                                             uint32_t* id, long long count,
                                             long long base, long long k,
                                             long long j) {
    for (long long p = threadIdx.x; p < count / 2; p += kThreads) {
        const long long x = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const long long y = x + j;
        const bool up = ((base + x) & k) == 0;
        const unsigned long long hx = hi[x], lx = lo[x], hy = hi[y],
                                 ly = lo[y];
        const uint32_t ix = id[x], iy = id[y];
        if (up ? key_less(hy, ly, iy, hx, lx, ix)
               : key_less(hx, lx, ix, hy, ly, iy)) {
            hi[x] = hy;
            lo[x] = ly;
            id[x] = iy;
            hi[y] = hx;
            lo[y] = lx;
            id[y] = ix;
        }
    }
}

// The keys of global rows [base, base + count) into shared memory;
// padding past n sorts last (the largest key, its own index).
__device__ __forceinline__ void load_keys(const MergeArgs& a,
                                          unsigned long long* hi,
                                          unsigned long long* lo,
                                          uint32_t* id, long long base,
                                          long long count) {
    for (long long x = threadIdx.x; x < count; x += kThreads) {
        const long long r = base + x;
        if (r < a.n) {
            row_key(a, r, hi[x], lo[x]);
        } else {
            hi[x] = lo[x] = ~0ull;
        }
        id[x] = (uint32_t)r;
    }
}

// The sizes of the shared key arrays of `count` keys.
__device__ __forceinline__ void key_arrays(unsigned char* smem,
                                           long long count,
                                           unsigned long long*& hi,
                                           unsigned long long*& lo,
                                           uint32_t*& id) {
    hi = reinterpret_cast<unsigned long long*>(smem);
    lo = hi + count;
    id = reinterpret_cast<uint32_t*>(lo + count);
}

// The combine over the sorted order (`order`: shared or device memory),
// by one block: heads, segments, the eight reductions and the fill rows.
__device__ void combine(const MergeArgs& a, const uint32_t* order) {
    __shared__ long long warp_heads[kWarps];
    __shared__ long long heads_before;
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const long long n = a.n;
    // The segments' identities, before any row combines into them.
    for (long long g = tid; g < n; g += kThreads) {
#pragma unroll
        for (int f = 0; f < kSums; ++f) a.o_sums[f][g] = 0;
#pragma unroll
        for (int f = 0; f < kMaxs; ++f) a.o_maxs[f][g] = INT_MIN;
#pragma unroll
        for (int f = 0; f < kMins; ++f) a.o_mins[f][g] = INT_MAX;
    }
    if (tid == 0) heads_before = 0;
    __syncthreads();

    for (long long t0 = 0; t0 < n; t0 += kThreads) {
        const long long i = t0 + tid;
        const bool in = i < n;
        const long long r = in ? order[i] : 0;
        const Row me = load_row(a, r);
        bool head = false;
        if (in) {
            bool same = false;
            if (i > 0 && me.live) {
                const Row pr = load_row(a, order[i - 1]);
                same = pr.live && pr.kind == me.kind &&
                       pr.chrom == me.chrom && pr.start == me.start &&
                       pr.end == me.end && pr.sense == me.sense;
            }
            head = me.live && !same;
        }
        int32_t v[8];
        row_values(a, r, me.live, v);
        // The block's inclusive scan of the heads.
        const unsigned ballot = __ballot_sync(kFull, head);
        const int incl = __popc(ballot & ((2u << lane) - 1u));
        if (lane == 31) warp_heads[w] = __popc(ballot);
        __syncthreads();
        if (w == 0) {
            const long long x = warp_heads[lane];
            long long sum = x;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const long long y = __shfl_up_sync(kFull, sum, o);
                if (lane >= o) sum += y;
            }
            warp_heads[lane] = sum - x;
        }
        __syncthreads();
        const long long base = heads_before;
        const long long seg =
            !in ? -1 : (me.live ? base + warp_heads[w] + incl - 1 : n - 1);
        if (head) {
            a.o_kind[seg] = me.kind;
            a.o_chrom[seg] = me.chrom;
            a.o_start[seg] = me.start;
            a.o_end[seg] = me.end;
            a.o_sense[seg] = me.sense;
        }
        // Each run of lanes in one segment reduces to its first lane.
        const long long up = __shfl_up_sync(kFull, seg, 1);
        const unsigned starts = __ballot_sync(kFull, lane == 0 || up != seg);
        const unsigned above = starts & ~((2u << lane) - 1u);
        const int last = above ? __ffs(above) - 2 : 31;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
            for (int f = 0; f < 8; ++f) {
                const int32_t y = __shfl_down_sync(kFull, v[f], o);
                if (lane + o <= last)
                    v[f] = f < kSums          ? v[f] + y
                           : f < kSums + kMaxs ? max(v[f], y)
                                              : min(v[f], y);
            }
        }
        if (in && (starts >> lane & 1u)) {
#pragma unroll
            for (int f = 0; f < kSums; ++f) atomicAdd(a.o_sums[f] + seg, v[f]);
#pragma unroll
            for (int f = 0; f < kMaxs; ++f)
                atomicMax(a.o_maxs[f] + seg, v[kSums + f]);
#pragma unroll
            for (int f = 0; f < kMins; ++f)
                atomicMin(a.o_mins[f] + seg, v[kSums + kMaxs + f]);
        }
        __syncthreads();
        if (tid == kThreads - 1) heads_before = base + warp_heads[w] + incl;
        __syncthreads();
    }

    // valid, and the fill rows past the heads: the last sorted row's keys.
    const long long n_heads = heads_before;
    const Row tail = load_row(a, order[n - 1]);
    for (long long g = tid; g < n; g += kThreads) {
        a.o_valid[g] = g < n_heads;
        if (g >= n_heads) {
            a.o_kind[g] = tail.kind;
            a.o_chrom[g] = tail.chrom;
            a.o_start[g] = tail.start;
            a.o_end[g] = tail.end;
            a.o_sense[g] = tail.sense;
        }
    }
}

// Up to kOneBlock rows: the keys, the whole sort in shared memory, then
// the combine from the sorted indices there.
__global__ void __launch_bounds__(kThreads)
merge_one_block(const __grid_constant__ MergeArgs a, long long P) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned long long *hi, *lo;
    uint32_t* id;
    key_arrays(smem, P, hi, lo, id);
    load_keys(a, hi, lo, id, 0, P);
    __syncthreads();
    for (long long k = 2; k <= P; k <<= 1) {
        for (long long j = k >> 1; j > 0; j >>= 1) {
            bitonic_step(hi, lo, id, P, 0, k, j);
            __syncthreads();
        }
    }
    combine(a, id);
}

// More rows, chunk by chunk of kOneBlock: with stage < 0 the chunk's keys
// from the rows and every stage up to kOneBlock; else stage `stage`'s
// steps below kOneBlock on the chunk's keys in device memory. Either way
// the chunk goes back to device memory.
__global__ void __launch_bounds__(kThreads)
merge_chunk(const __grid_constant__ MergeArgs a, long long stage) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned long long *hi, *lo;
    uint32_t* id;
    key_arrays(smem, kOneBlock, hi, lo, id);
    const long long base = (long long)blockIdx.x * kOneBlock;
    if (stage < 0) {
        load_keys(a, hi, lo, id, base, kOneBlock);
    } else {
        for (int x = threadIdx.x; x < kOneBlock; x += kThreads) {
            hi[x] = a.key_hi[base + x];
            lo[x] = a.key_lo[base + x];
            id[x] = a.order[base + x];
        }
    }
    __syncthreads();
    for (long long k = stage < 0 ? 2 : stage;
         k <= (stage < 0 ? kOneBlock : stage); k <<= 1) {
        for (long long j = (k >> 1) < kOneBlock ? k >> 1 : kOneBlock >> 1;
             j > 0; j >>= 1) {
            bitonic_step(hi, lo, id, kOneBlock, base, k, j);
            __syncthreads();
        }
    }
    for (int x = threadIdx.x; x < kOneBlock; x += kThreads) {
        a.key_hi[base + x] = hi[x];
        a.key_lo[base + x] = lo[x];
        a.order[base + x] = id[x];
    }
}

// One step (k, j >= kOneBlock) of the network across chunks: a thread a
// compare-exchange.
__global__ void __launch_bounds__(256)
merge_step(const __grid_constant__ MergeArgs a, long long P, long long k,
           long long j) {
    const long long p = (long long)blockIdx.x * 256 + threadIdx.x;
    if (p >= P / 2) return;
    const long long x = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const long long y = x + j;
    const bool up = (x & k) == 0;
    const unsigned long long hx = a.key_hi[x], lx = a.key_lo[x],
                             hy = a.key_hi[y], ly = a.key_lo[y];
    const uint32_t ix = a.order[x], iy = a.order[y];
    if (up ? key_less(hy, ly, iy, hx, lx, ix)
           : key_less(hx, lx, ix, hy, ly, iy)) {
        a.key_hi[x] = hy;
        a.key_lo[x] = ly;
        a.order[x] = iy;
        a.key_hi[y] = hx;
        a.key_lo[y] = lx;
        a.order[y] = ix;
    }
}

__global__ void __launch_bounds__(kThreads)
merge_combine(const __grid_constant__ MergeArgs a) {
    combine(a, a.order);
}

}  // namespace

// Host side: the C entry.

// The merged table of the n rows.
extern "C" int fc2t_merge(const MergeArgs* a) {
    if (a->n <= 0) return 0;
    const bool table = a->valid != nullptr;
    bool given = a->kind && a->chrom && a->start && a->end && a->sense &&
                 a->o_valid && a->o_kind && a->o_chrom && a->o_start &&
                 a->o_end && a->o_sense;
    for (int f = 0; f < kSums; ++f)
        given = given && (table == (a->sums[f] != nullptr)) && a->o_sums[f];
    for (int f = 0; f < kMaxs; ++f) given = given && a->maxs[f] && a->o_maxs[f];
    for (int f = 0; f < kMins; ++f) given = given && a->mins[f] && a->o_mins[f];
    if (!table) given = given && a->status && a->lens && a->align_strand;
    long long P = 1;
    while (P < a->n) P <<= 1;
    const bool chunks = P > kOneBlock;
    if (!given || a->n > (1ll << 31) - 1 ||
        chunks != (a->key_hi != nullptr) || chunks != (a->order != nullptr) ||
        (a->key_lo != nullptr) != chunks)
        return -(int)cudaErrorInvalidValue;
    int dev = -1;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -(int)err;
    if (dev != a->device) return -(int)cudaErrorInvalidDevice;
    if (a->device < 0 || a->device >= kMaxDevices)
        return -(int)cudaErrorInvalidDevice;
    // Shared memory above 48 KB, once a device (a racing second call sets
    // it again).
    static bool opened[kMaxDevices];
    const size_t most = kOneBlock * kKeyBytes;
    if (!opened[a->device]) {
        err = cudaFuncSetAttribute(
            merge_one_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)most);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                merge_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)most);
        if (err != cudaSuccess) return -(int)err;
        opened[a->device] = true;
    }
    const cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
    if (!chunks) {
        merge_one_block<<<1, kThreads, P * kKeyBytes, stream>>>(*a, P);
        err = cudaGetLastError();
        return err == cudaSuccess ? 1 : -(int)err;
    }
    const unsigned blocks = (unsigned)(P / kOneBlock);
    int launched = 0;
    merge_chunk<<<blocks, kThreads, most, stream>>>(*a, -1);
    ++launched;
    for (long long k = 2ll * kOneBlock; k <= P; k <<= 1) {
        for (long long j = k >> 1; j >= kOneBlock; j >>= 1) {
            merge_step<<<(unsigned)((P / 2 + 255) / 256), 256, 0, stream>>>(
                *a, P, k, j);
            ++launched;
        }
        merge_chunk<<<blocks, kThreads, most, stream>>>(*a, k);
        ++launched;
    }
    merge_combine<<<1, kThreads, 0, stream>>>(*a);
    ++launched;
    err = cudaGetLastError();
    return err == cudaSuccess ? launched : -(int)err;
}
