// Row gather: out_t[i, :] = table_t[idx[i], :] for one or two int32
// tables [T, W_t] that share the index vector.
//
// Replaces find_circ2_tpu/ops/pallas_k1.py:gather_rows_pallas, which
// walked the rows with a DEPTH-8 chain of per-row DMAs. The callers'
// indices are hashes or table row ids, so every row is one or a few
// random 32-byte DRAM sectors and the gather does no arithmetic. Its
// bound on this card is bytes: each index read once, each row read once
// and written once, over 3.35 TB/s. What keeps it from that bound is the
// number of independent sector reads in flight and the instructions
// spent per byte, so the design:
//
//  * A warp owns a tile of 32 consecutive rows. Each lane loads one
//    row's index once, with one coalesced load per tile, and the lanes
//    that move that row's vectors take it by warp shuffle: no index is
//    reloaded per vector and no 64-bit division is done. Offsets inside
//    a tile are 32-bit; the tile's base is the only 64-bit product.
//  * Rows move in the widest vector the row bytes and the bases allow:
//    16 bytes (K1's 32-byte table and neighbour-table rows, two vectors
//    a row), else 8 bytes (explore's 8-byte ext_id rows, one vector, and
//    its 120-byte ext rows, fifteen), else 4. Those three widths have
//    the vectors per row as a template constant; any other width takes
//    the runtime path. A view may start at any 4-byte offset, so a base
//    that is not aligned for the wider vector falls back to a narrower
//    one.
//  * Lane l of a warp moves the tile's vectors 32 * k + l, k = 0, 1, ...:
//    the lanes that load one 32-byte row read one sector, and a warp's
//    stores are consecutive, so every store is coalesced.
//  * Each thread issues all its row loads (its vectors of the tile in
//    both tables, one to fifteen) before its first store. One tile per
//    warp and loop, 256-thread blocks: at the main path's sizes more
//    warps in flight beat more tiles per warp (two or four tiles per
//    warp were slower on the card). Loads and stores stream
//    (ld.global.cs / st.global.cs): no row is reused.
//  * What remains is the memory: a row of 8 to 32 bytes costs a whole
//    random HBM access, and a launch pays two dependent HBM latencies
//    (index, then row) before its first store, so on tables larger than
//    the L2 the kernel reaches a quarter to two fifths of the bytes
//    bound at the main path's 10^5 rows (PERF.md).
//  * Two tables that share the indices (K1's table and neighbour table,
//    explore's table and ext_id) are gathered by one launch.
//
// TMA and wgmma do not serve here: there is no tile to copy and no
// product. A TMA copy per hashed row would bring back the per-row
// descriptor cost that bounded the Pallas kernel.
//
// Plain C interface for ctypes: one packed argument buffer (GatherArgs).
// The entry returns the number of kernels it launched, or minus the CUDA
// error of the launch.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// One tile's vectors of one table, with the vectors per row fixed.
template <typename Vec, int VPR>
struct FixedRows {
    static constexpr int kVpr = VPR;
    Vec v[VPR];

    // `r` is this lane's row of the tile, `nv` the tile's vectors.
    __device__ __forceinline__ void load(const void* table, long long r,
                                         int nv, int lane) {
        const Vec* t = static_cast<const Vec*>(table);
#pragma unroll
        for (int k = 0; k < VPR; ++k) {
            const int j = k * 32 + lane;
            const int row = j / VPR;
            const long long src =
                VPR == 1 ? r : __shfl_sync(kFull, r, row);
            if (j < nv) v[k] = __ldcs(t + src * VPR + (j - row * VPR));
        }
    }

    __device__ __forceinline__ void store(void* out, long long row0,
                                          int nv, int lane) const {
        Vec* o = static_cast<Vec*>(out) + row0 * VPR;
#pragma unroll
        for (int k = 0; k < VPR; ++k) {
            const int j = k * 32 + lane;
            if (j < nv) __stcs(o + j, v[k]);
        }
    }
};

// No second table.
struct NoRows {
    static constexpr int kVpr = 0;
    __device__ __forceinline__ void load(const void*, long long, int,
                                         int) {}
    __device__ __forceinline__ void store(void*, long long, int,
                                          int) const {}
};

template <typename Index>
__device__ __forceinline__ long long tile_row(const Index* __restrict__ idx,
                                              long long base, long long n,
                                              long long n_rows, int lane) {
    long long r = 0;
    if (base + lane < n) {
        r = (long long)__ldcs(idx + base + lane);
        // Same contract as index_select: an index outside the table is a
        // fault, reported as a device-side assert.
        assert(r >= 0 && r < n_rows);
    }
    return r;
}

// One tile of 32 rows per warp and loop: the loads of both tables are
// issued before the first store.
template <typename Index, class A, class B>
__global__ void __launch_bounds__(kThreads)
gather_fixed_kernel(const void* __restrict__ ta, void* __restrict__ oa,
                    const void* __restrict__ tb, void* __restrict__ ob,
                    const Index* __restrict__ idx, long long n,
                    long long n_rows) {
    const int lane = threadIdx.x & 31;
    const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x)
                           >> 5;
    const long long n_warps = ((long long)gridDim.x * kThreads) >> 5;
    for (long long row0 = warp * 32; row0 < n; row0 += n_warps * 32) {
        const long long left = n - row0;
        const int rows = left < 32 ? (int)left : 32;
        const long long r = tile_row(idx, row0, n, n_rows, lane);
        A a;
        B b;
        a.load(ta, r, rows * A::kVpr, lane);
        b.load(tb, r, rows * B::kVpr, lane);
        a.store(oa, row0, rows * A::kVpr, lane);
        b.store(ob, row0, rows * B::kVpr, lane);
    }
}

// Any other width: the vectors per row at run time, four loads in
// flight per thread.
template <typename Index, typename Vec>
__global__ void __launch_bounds__(kThreads)
gather_runtime_kernel(const Vec* __restrict__ table, Vec* __restrict__ out,
                      const Index* __restrict__ idx, long long n,
                      long long n_rows, int vpr) {
    const int lane = threadIdx.x & 31;
    const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x)
                           >> 5;
    const long long n_warps = ((long long)gridDim.x * kThreads) >> 5;
    for (long long row0 = warp * 32; row0 < n; row0 += n_warps * 32) {
        const long long left = n - row0;
        const int nv = (left < 32 ? (int)left : 32) * vpr;
        const long long r = tile_row(idx, row0, n, n_rows, lane);
        Vec* o = out + row0 * vpr;
        for (int k0 = 0; k0 < vpr; k0 += 4) {
            Vec v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int j = (k0 + u) * 32 + lane;
                const int row = j / vpr;
                const long long src = __shfl_sync(kFull, r, row & 31);
                if (j < nv)
                    v[u] = __ldcs(table + src * vpr + (j - row * vpr));
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int j = (k0 + u) * 32 + lane;
                if (j < nv) __stcs(o + j, v[u]);
            }
        }
    }
}

// How one table's rows move: the vector and whether the vectors per row
// are a template constant.
enum Kind { kInt4x2, kInt2x1, kInt2x15, kInt4Any, kInt2Any, kInt1Any };

Kind kind_of(const void* table, const void* out, int w, int* vpr) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(table) |
                            reinterpret_cast<uintptr_t>(out);
    if (w % 4 == 0 && bases % 16 == 0) {
        *vpr = w / 4;
        return w == 8 ? kInt4x2 : kInt4Any;
    }
    if (w % 2 == 0 && bases % 8 == 0) {
        *vpr = w / 2;
        return w == 2 ? kInt2x1 : (w == 30 ? kInt2x15 : kInt2Any);
    }
    *vpr = w;
    return kInt1Any;
}

int g_sms[kMaxDevices];  // SM count per device, read once

struct Launch {
    long long n, n_rows;
    int sms;
    cudaStream_t stream;
};

// One warp per 32-row tile, as many blocks as that takes, up to a full
// load of every SM; the grid-stride loop covers the rest.
long long grid(const Launch& L) {
    const long long rows_per_block = (kThreads / 32) * 32LL;
    const long long blocks = (L.n + rows_per_block - 1) / rows_per_block;
    const long long cap = (long long)L.sms * (2048 / kThreads);
    return blocks < cap ? blocks : cap;
}

template <typename Index, class A, class B>
void launch_fixed(const Launch& L, const void* ta, void* oa, const void* tb,
                  void* ob, const void* idx) {
    gather_fixed_kernel<Index, A, B>
        <<<(unsigned)grid(L), kThreads, 0, L.stream>>>(
            ta, oa, tb, ob, static_cast<const Index*>(idx), L.n, L.n_rows);
}

template <typename Index, typename Vec>
void launch_runtime(const Launch& L, const void* t, void* o, int vpr,
                    const void* idx) {
    gather_runtime_kernel<Index, Vec>
        <<<(unsigned)grid(L), kThreads, 0, L.stream>>>(
            static_cast<const Vec*>(t), static_cast<Vec*>(o),
            static_cast<const Index*>(idx), L.n, L.n_rows, vpr);
}

template <typename Index>
void launch_one(const Launch& L, const void* t, void* o, int w,
                const void* idx) {
    int vpr = 0;
    switch (kind_of(t, o, w, &vpr)) {
    case kInt4x2:
        launch_fixed<Index, FixedRows<int4, 2>, NoRows>(L, t, o, nullptr,
                                                        nullptr, idx);
        break;
    case kInt2x1:
        launch_fixed<Index, FixedRows<int2, 1>, NoRows>(L, t, o, nullptr,
                                                        nullptr, idx);
        break;
    case kInt2x15:
        launch_fixed<Index, FixedRows<int2, 15>, NoRows>(L, t, o, nullptr,
                                                         nullptr, idx);
        break;
    case kInt4Any:
        launch_runtime<Index, int4>(L, t, o, vpr, idx);
        break;
    case kInt2Any:
        launch_runtime<Index, int2>(L, t, o, vpr, idx);
        break;
    case kInt1Any:
        launch_runtime<Index, int>(L, t, o, vpr, idx);
        break;
    }
}

// Two tables: one launch for the main path's pairs, else one each.
template <typename Index>
int launch_pair(const Launch& L, const void* ta, void* oa, int wa,
                const void* tb, void* ob, int wb, const void* idx) {
    int va = 0, vb = 0;
    const Kind ka = kind_of(ta, oa, wa, &va);
    const Kind kb = kind_of(tb, ob, wb, &vb);
    if (ka == kInt4x2 && kb == kInt4x2) {
        launch_fixed<Index, FixedRows<int4, 2>, FixedRows<int4, 2>>(
            L, ta, oa, tb, ob, idx);
        return 1;
    }
    if (ka == kInt4x2 && kb == kInt2x1) {
        launch_fixed<Index, FixedRows<int4, 2>, FixedRows<int2, 1>>(
            L, ta, oa, tb, ob, idx);
        return 1;
    }
    launch_one<Index>(L, ta, oa, wa, idx);
    launch_one<Index>(L, tb, ob, wb, idx);
    return 2;
}

}  // namespace

// The arguments of one call, packed by the caller into one buffer:
// ctypes converts one pointer much faster than twelve arguments.
struct GatherArgs {
    const void* table_a;  // [n_rows or more, width_a] int32
    void* out_a;          // [n, width_a] int32
    const void* table_b;  // null: table_a only
    void* out_b;
    const void* idx;      // [n] int32 or int64
    long long n;          // > 0
    long long n_rows;     // rows of the shorter table
    void* stream;
    int width_a, width_b, idx_is_64, device;
};
static_assert(sizeof(GatherArgs) == 80, "layout packed by ops/gather_rows");

// out_a = table_a[idx] and, when table_b is not null, out_b =
// table_b[idx].
extern "C" int fc2t_gather_rows(const GatherArgs* a) {
    if (a->n <= 0 || a->width_a <= 0 ||
        (a->table_b != nullptr && a->width_b <= 0))
        return 0;
    if (a->device < 0 || a->device >= kMaxDevices)
        return -(int)cudaErrorInvalidDevice;
    // The stream may be the null handle of the default stream, which
    // launches on the current device: refuse any other device's pointers.
    int current = -1;
    const cudaError_t got = cudaGetDevice(&current);
    if (got != cudaSuccess) return -(int)got;
    if (current != a->device) return -(int)cudaErrorInvalidDevice;
    if (g_sms[a->device] == 0) {
        int sms = 0;
        const cudaError_t err = cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, a->device);
        if (err != cudaSuccess) return -(int)err;
        g_sms[a->device] = sms;
    }
    const Launch L{a->n, a->n_rows, g_sms[a->device],
                   static_cast<cudaStream_t>(a->stream)};
    int launches = 1;
    if (a->table_b == nullptr) {
        if (a->idx_is_64)
            launch_one<long long>(L, a->table_a, a->out_a, a->width_a,
                                  a->idx);
        else
            launch_one<int>(L, a->table_a, a->out_a, a->width_a, a->idx);
    } else if (a->idx_is_64) {
        launches = launch_pair<long long>(L, a->table_a, a->out_a,
                                          a->width_a, a->table_b, a->out_b,
                                          a->width_b, a->idx);
    } else {
        launches = launch_pair<int>(L, a->table_a, a->out_a, a->width_a,
                                    a->table_b, a->out_b, a->width_b,
                                    a->idx);
    }
    const cudaError_t err = cudaGetLastError();
    return err == cudaSuccess ? launches : -(int)err;
}
