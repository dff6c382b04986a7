// Chunked ("ragged") sliced-ELL sparse matrix-vector product y = A x for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
// domain_decomposed_pde_solver_tpu/ops/bsg.py::_spmv_ragged_kernel (launched by
// _bsg_spmv_ragged): the BSG product with its micro-ops stored in flat chunks,
// one chunk per grid step, a chunk -> tile map, the first chunk of a tile
// writing the tile and later chunks adding to it.  The port keeps that job on
// the GPU's own layout, the sliced ELL of csrc/spmv.cu:
//
// Format.  Rows are cut into slices of 32.  Each slice's width is rounded up
// to a multiple of C (the chunk), and a chunk is C slot columns of one slice:
// 32 * C slots, column-major (slot j of lane i at 32*j + i inside the chunk).
// Because every width is a multiple of C, chunk k starts at slot 32*C*k, so
// the chunks are stored flat and need no pointer of their own.  chunk_ptr[s]
// is the first chunk of slice s (chunk_ptr[n_slices] = n_chunks); a slice of
// width 0 owns no chunk.  Padding slots hold (col 0, value 0).
//
// Why chunks on a GPU.  In the one-thread-per-row kernel (csrc/spmv.cu) a
// slice holds its warp for the whole slice width: a slice of a few very wide
// rows (the transposed tentative transfer of AMG) keeps one warp busy while
// the rest of the card idles.  Here a warp takes one chunk, a fixed amount
// of work whatever the slice's width, so wide slices spread over many warps.
//
// Determinism.  Pass 1 writes one partial sum per row of every chunk into a
// scratch buffer (no atomics).  Pass 2, one thread per row, adds the partials
// of its slice's chunks in chunk order, as the TPU kernel does (the first
// chunk writes, later chunks add).  Results are identical from run to run.
//
// Bound.  Bytes, as for csrc/spmv.cu: slots x (4 B column + value bytes), x
// gathered once per slot, y written once per row, two flops per slot.  The
// scratch adds one write and one read of 32 partials per chunk, 1/C of the
// slot stream's element count.
//
// Contract.  Columns are int32.  Values are V (float or double), x, y and the
// accumulators T (float or double) with sizeof(V) <= sizeof(T).  A column
// >= n_x reads x as 0.  Pad rows and rows of slices without chunks give 0.
// The launch allocates nothing (the caller passes the scratch, n_chunks * 32
// entries of T), runs on the caller's stream, does not synchronise, and each
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kSlice = 32;
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / kSlice;  // chunks per block in pass 1

template <typename V, typename T>
__global__ void __launch_bounds__(kBlock)
chunk_partials_kernel(const int32_t* __restrict__ cols,
                      const V* __restrict__ vals,
                      const T* __restrict__ x,
                      T* __restrict__ partial,
                      int64_t n_chunks, int chunk, int64_t n_x) {
  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kSlice;
  if (k >= n_chunks) return;
  const int lane = threadIdx.x % kSlice;
  const int64_t base = k * kSlice * chunk + lane;
  T acc = T(0);
  for (int j = 0; j < chunk; ++j) {
    const int64_t slot = base + static_cast<int64_t>(j) * kSlice;
    const int32_t c = __ldg(cols + slot);
    const T xv = (c < n_x) ? __ldg(x + c) : T(0);
    acc += static_cast<T>(__ldg(vals + slot)) * xv;
  }
  partial[k * kSlice + lane] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
combine_kernel(const int32_t* __restrict__ chunk_ptr,
               const T* __restrict__ partial,
               T* __restrict__ y, int64_t n_out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (row >= n_out) return;
  const int64_t s = row / kSlice;
  const int lane = static_cast<int>(row % kSlice);
  const int64_t k1 = __ldg(chunk_ptr + s + 1);
  T acc = T(0);
  for (int64_t k = __ldg(chunk_ptr + s); k < k1; ++k) {
    acc += __ldg(partial + k * kSlice + lane);
  }
  y[row] = acc;
}

template <typename V, typename T>
int launch(const void* cols, const void* vals, const void* chunk_ptr,
           void* partial, const void* x, void* y, int64_t n_chunks, int chunk,
           int64_t n_out, int64_t n_x, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    const int64_t blocks = (n_chunks + kWarps - 1) / kWarps;
    chunk_partials_kernel<V, T><<<static_cast<unsigned>(blocks), kBlock, 0,
                                  st>>>(
        static_cast<const int32_t*>(cols), static_cast<const V*>(vals),
        static_cast<const T*>(x), static_cast<T*>(partial), n_chunks, chunk,
        n_x);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_out > 0) {
    const int64_t blocks = (n_out + kBlock - 1) / kBlock;
    combine_kernel<T><<<static_cast<unsigned>(blocks), kBlock, 0, st>>>(
        static_cast<const int32_t*>(chunk_ptr),
        static_cast<const T*>(partial), static_cast<T*>(y), n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define DDPS_CHUNKED_ENTRY(NAME, V, T)                                       \
  int NAME(const void* cols, const void* vals, const void* chunk_ptr,        \
           void* partial, const void* x, void* y, int64_t n_chunks,          \
           int chunk, int64_t n_out, int64_t n_x, void* stream) {            \
    return launch<V, T>(cols, vals, chunk_ptr, partial, x, y, n_chunks,      \
                        chunk, n_out, n_x, stream);                          \
  }

// Storage float, vectors float; storage float, vectors double; storage
// double, vectors double (the three instantiations of csrc/spmv.cu).
DDPS_CHUNKED_ENTRY(ddps_sell_chunked_spmv_f32_f32, float, float)
DDPS_CHUNKED_ENTRY(ddps_sell_chunked_spmv_f32_f64, float, double)
DDPS_CHUNKED_ENTRY(ddps_sell_chunked_spmv_f64_f64, double, double)

#undef DDPS_CHUNKED_ENTRY

const char* ddps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
