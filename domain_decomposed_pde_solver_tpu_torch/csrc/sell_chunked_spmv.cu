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
// Format.  The slots are the dense layout's: rows cut into slices of 32,
// slice s of width w[s] at [slice_ptr[s], slice_ptr[s+1]), slot j of lane i
// at slice_ptr[s] + 32*j + i, padding slots (col 0, value 0).  A chunk is C
// slot columns of one slice: slice s owns ceil(w[s] / C) chunks, numbered
// slice after slice from chunk_ptr[s] (chunk_ptr[n_slices] = n_chunks), and
// its chunk j holds columns [C*j, min(C*(j+1), w[s])), so the last one is
// short and no slot is added for the chunking.  tmap[k] is the slice of
// chunk k.  A chunk's first slot and width follow from slice_ptr and its
// position in its slice: no pointer array of its own.
//
// Work per warp.  A slice of at most K chunks is one warp's, one lane per
// row (K = DDPS_WARP_CHUNKS, defined at build time by ops/_kernels.py from
// the WARP_CHUNKS the host packer lists the wide chunks by, so the two
// cannot disagree): the warp forms each chunk's partial over the chunk's
// columns in order and adds the partials in chunk order in registers, then
// writes y.  Only a slice of more than K
// chunks (a few very wide rows, as the transposed tentative transfer of
// AMG has) is spread one chunk per warp, so it does not hold one warp for
// its whole width while the card idles: the caller lists those chunks
// (`wide`, ascending), each such warp writes its partials to scratch,
// counts its arrival on the slice's integer counter, and the warp that
// arrives last adds the slice's partials in chunk order and writes y.  One
// launch; the counter, not a second pass, does the combine, so a matrix
// without wide slices runs exactly the one-warp route and touches no
// scratch.
//
// Determinism.  Every row's sum has one order, fixed by the layout: columns
// in order inside a chunk, chunks in order inside a slice.  The only
// atomics are the integer arrival counts, which pick the warp that adds,
// not the order it adds in.  Results are identical from run to run.
//
// Bound.  Bytes, as for csrc/spmv.cu: slots x (4 B column + value bytes), x
// gathered once per slot, y written once per row, two flops per slot: the
// same compulsory bytes as the dense product of the same operator.  The
// one-warp route reads exactly those, in kernel 1's order (a warp reads its
// slice's columns and values as contiguous 128-byte lines); the wide route
// adds one write and one read of 32 partials per wide chunk.  On the
// 833,048-row refined box at chunk 16 (every slice one warp's) it takes
// 0.0530 ms, against 0.0494 ms for csrc/spmv.cu and 0.0622 ms for cuSPARSE
// CSR on the same product, bound 0.0385 ms, each device time per call from
// torch.profiler (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase E).
//
// Contract.  Columns are int32, slice_ptr int64, chunk_ptr, tmap and wide
// int32.  Values are V (float or double), x, y and the accumulators T
// (float or double) with sizeof(V) <= sizeof(T).  A column >= n_x reads x
// as 0.  Pad rows and rows of slices without chunks give 0.  The caller
// passes the scratch: n_wide * 32 entries of T and n_wide int32 arrival
// counters set to 0 (both may be null when n_wide = 0).  The launch
// allocates nothing, runs on the caller's stream, does not synchronise, and
// each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kSlice = 32;
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / kSlice;  // warps (slices or chunks) per block
#ifndef DDPS_WARP_CHUNKS
#error "build with -DDDPS_WARP_CHUNKS=K, the packer's chunks per warp"
#endif
constexpr int kWarpChunks = DDPS_WARP_CHUNKS;  // K

// One lane's partial over `width` slot columns from `slot` (its own row).
template <typename V, typename T>
__device__ __forceinline__ T chunk_partial(const int32_t* __restrict__ cols,
                                           const V* __restrict__ vals,
                                           const T* __restrict__ x,
                                           int64_t slot, int width,
                                           int64_t n_x) {
  T part = T(0);
#pragma unroll 4
  for (int j = 0; j < width; ++j) {
    const int32_t c = __ldg(cols + slot);
    const T xv = (c < n_x) ? __ldg(x + c) : T(0);
    part += static_cast<T>(__ldg(vals + slot)) * xv;
    slot += kSlice;
  }
  return part;
}

template <typename V, typename T>
__global__ void __launch_bounds__(kBlock)
chunked_spmv_kernel(const int64_t* __restrict__ slice_ptr,
                    const int32_t* __restrict__ cols,
                    const V* __restrict__ vals,
                    const int32_t* __restrict__ tmap,
                    const int32_t* __restrict__ chunk_ptr,
                    const int32_t* __restrict__ wide,
                    T* __restrict__ partial, int32_t* __restrict__ arrivals,
                    const T* __restrict__ x, T* __restrict__ y,
                    int64_t n_slices, int64_t n_wide, int chunk,
                    int64_t n_out, int64_t n_x) {
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kSlice;
  const int lane = threadIdx.x % kSlice;
  if (warp < n_slices) {
    // One-warp route: the whole slice, chunk after chunk.  A slice of
    // width w owns ceil(w / chunk) chunks, more than K exactly when
    // w > K * chunk: no chunk map is read here.
    const int64_t s = warp;
    const int64_t p0 = __ldg(slice_ptr + s);
    const int w = static_cast<int>((__ldg(slice_ptr + s + 1) - p0) / kSlice);
    if (w > kWarpChunks * chunk) return;  // spread over the wide route
    int64_t slot = p0 + lane;
    T acc = T(0);
    for (int j0 = 0; j0 < w; j0 += chunk) {
      acc += chunk_partial<V, T>(cols, vals, x, slot, min(chunk, w - j0), n_x);
      slot += static_cast<int64_t>(chunk) * kSlice;
    }
    const int64_t row = s * kSlice + lane;
    if (row < n_out) y[row] = acc;
    return;
  }
  // Wide route: one chunk of a slice of more than K chunks.
  const int64_t i = warp - n_slices;
  if (i >= n_wide) return;
  const int32_t k = __ldg(wide + i);
  const int64_t s = __ldg(tmap + k);
  const int32_t k0 = __ldg(chunk_ptr + s);
  const int nk = __ldg(chunk_ptr + s + 1) - k0;
  const int j = k - k0;          // position of the chunk in its slice
  const int64_t first = i - j;   // wide-list position of the slice's chunk 0
  const int64_t p0 = __ldg(slice_ptr + s);
  const int w = static_cast<int>((__ldg(slice_ptr + s + 1) - p0) / kSlice);
  const T part = chunk_partial<V, T>(
      cols, vals, x, p0 + static_cast<int64_t>(chunk) * kSlice * j + lane,
      min(chunk, w - chunk * j), n_x);
  partial[i * kSlice + lane] = part;
  // Publish the partial, then count the arrival; the warp that arrives last
  // sees every partial of the slice and adds them in chunk order.
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(arrivals + first, 1) == nk - 1;
  last = __shfl_sync(0xffffffffu, last, 0);
  if (!last) return;
  __threadfence();
  T acc = T(0);
  for (int q = 0; q < nk; ++q) {
    acc += __ldcg(partial + (first + q) * kSlice + lane);
  }
  const int64_t row = s * kSlice + lane;
  if (row < n_out) y[row] = acc;
}

template <typename V, typename T>
int launch(const void* slice_ptr, const void* cols, const void* vals,
           const void* tmap, const void* chunk_ptr, const void* wide,
           void* partial, void* arrivals, const void* x, void* y,
           int64_t n_slices, int64_t n_wide, int chunk, int64_t n_out,
           int64_t n_x, void* stream) {
  if (chunk < 1 || n_slices < 0 || n_wide < 0 ||
      n_out > n_slices * kSlice) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t warps = n_slices + n_wide;
  if (warps > 0) {
    const int64_t blocks = (warps + kWarps - 1) / kWarps;
    chunked_spmv_kernel<V, T><<<static_cast<unsigned>(blocks), kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(slice_ptr),
        static_cast<const int32_t*>(cols), static_cast<const V*>(vals),
        static_cast<const int32_t*>(tmap),
        static_cast<const int32_t*>(chunk_ptr),
        static_cast<const int32_t*>(wide), static_cast<T*>(partial),
        static_cast<int32_t*>(arrivals), static_cast<const T*>(x),
        static_cast<T*>(y), n_slices, n_wide, chunk, n_out, n_x);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define DDPS_CHUNKED_ENTRY(NAME, V, T)                                        \
  int NAME(const void* slice_ptr, const void* cols, const void* vals,        \
           const void* tmap, const void* chunk_ptr, const void* wide,        \
           void* partial, void* arrivals, const void* x, void* y,            \
           int64_t n_slices, int64_t n_wide, int chunk, int64_t n_out,       \
           int64_t n_x, void* stream) {                                      \
    return launch<V, T>(slice_ptr, cols, vals, tmap, chunk_ptr, wide,        \
                        partial, arrivals, x, y, n_slices, n_wide, chunk,    \
                        n_out, n_x, stream);                                 \
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
