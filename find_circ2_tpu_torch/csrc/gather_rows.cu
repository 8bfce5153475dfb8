// Row gather: out[i, :] = table[idx[i], :] for an int32 table [T, W].
//
// Replaces find_circ2_tpu/ops/pallas_k1.py:gather_rows_pallas, which
// walked the rows with a DEPTH-8 chain of per-row DMAs. The callers'
// indices are hashes or table row ids, so every row is one random DRAM
// sector: the gather is bound by how many independent sector reads are
// in flight, not by bandwidth. The design keeps as many in flight as the
// card allows: one thread per vector of a row, a grid-stride loop over
// all vectors with enough blocks to fill every SM, and no dependency
// between a thread's loads.
//
// Two vector widths. Rows of a multiple of 16 bytes (K1's 32-byte query
// and neighbour-table rows) move as int4, two threads per K1 row. Any
// other width (§2b explore's 8-byte ext_id rows and 120-byte ext rows)
// moves as 4-byte words, one thread per word.
//
// Plain C interface for ctypes; every pointer and the stream arrive as
// void*. The entry returns cudaGetLastError() after the launch.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename Vec, typename Index>
__global__ void gather_rows_kernel(const Vec* __restrict__ table,
                                   const Index* __restrict__ idx,
                                   Vec* __restrict__ out,
                                   long long n_vec, int vec_per_row,
                                   long long n_rows) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         v < n_vec; v += stride) {
        const long long i = v / vec_per_row;
        const int c = (int)(v - i * vec_per_row);
        const long long r = (long long)__ldg(&idx[i]);
        // Same contract as index_select: an index outside the table is
        // a fault, reported as a device-side assert.
        assert(r >= 0 && r < n_rows);
        out[v] = __ldg(&table[r * vec_per_row + c]);
    }
}

template <typename Vec, typename Index>
void launch(const void* table, const void* idx, void* out, long long n_vec,
            int vec_per_row, long long n_rows, unsigned blocks, int threads,
            cudaStream_t s) {
    gather_rows_kernel<Vec, Index><<<blocks, threads, 0, s>>>(
        static_cast<const Vec*>(table), static_cast<const Index*>(idx),
        static_cast<Vec*>(out), n_vec, vec_per_row, n_rows);
}

}  // namespace

extern "C" int fc2t_gather_rows(const void* table, const void* idx,
                                void* out, long long n, long long n_rows,
                                int row_words, int idx_is_64,
                                void* stream) {
    if (n <= 0 || row_words <= 0) return 0;
    // int4 needs 16-byte rows and 16-byte aligned bases (a view may
    // start anywhere); everything else takes the word path.
    const bool wide = row_words % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int vec_per_row = wide ? row_words / 4 : row_words;
    const long long n_vec = n * vec_per_row;
    const int threads = 256;
    // Enough blocks to fill every SM many times over; the loop covers
    // whatever the grid does not.
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const long long max_blocks = (long long)sms * 32;
    long long blocks = (n_vec + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned b = (unsigned)blocks;
    if (wide && idx_is_64)
        launch<int4, long long>(table, idx, out, n_vec, vec_per_row, n_rows,
                                b, threads, s);
    else if (wide)
        launch<int4, int>(table, idx, out, n_vec, vec_per_row, n_rows, b,
                          threads, s);
    else if (idx_is_64)
        launch<int, long long>(table, idx, out, n_vec, vec_per_row, n_rows,
                               b, threads, s);
    else
        launch<int, int>(table, idx, out, n_vec, vec_per_row, n_rows, b,
                         threads, s);
    return (int)cudaGetLastError();
}
