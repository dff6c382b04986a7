// Sliced-ELL sparse matrix-vector product y = A x for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel domain_decomposed_pde_solver_tpu/ops/bsg.py::_spmv_kernel
// (the dense-layout BSG shuffle-gather SpMV launched by bsg_spmv).  That kernel
// exists because the TPU has no vector gather; Hopper has one, so the port keeps
// the job (y = A x in the operator's permuted, padded space, square or
// rectangular) and drops the micro-op layout.
//
// Format.  Rows are cut into slices of 32 (one warp).  Slice s stores
// width[s] = max row length of its 32 rows, and its slots lie at
// [slice_ptr[s], slice_ptr[s+1]) in column-major order: slot j of lane i is at
// slice_ptr[s] + 32*j + i.  Shorter rows are padded with value 0 (column 0,
// or a column past the input where the packer says so).
//
// Several row blocks, one launch.  A partitioned operator packs the real
// rows of all of a process's parts back to back as one operator (no halo
// rows, no padding per part: a slice may straddle two parts) whose columns
// are positions in the vector the parts gather from, so one launch reads
// that vector and writes every part's rows in place.  A padding slot adds
// an exact 0 (0 * 0 to a sum that is never -0), so a row's result is the
// same bits in any packing that keeps its real slots in the same order.
//
// Bound.  On this card the kernel is bound by bytes, not operations: every
// slot reads a column (4 B) and a value (1, 2, 4 or 8 B) once and gathers
// x, every row writes y once, at two flops per slot.  What stood between
// the first design (one slot at a time per thread) and that bound was
// latency: a thread loaded a column, then gathered x, then added, with
// one load in flight, so only occupancy hid the latency, and a part of
// 100k rows gives too little of it.  This design keeps four slots of a
// row in flight: it loads four columns and values (32 slots apart, so each
// of the four is one contiguous line across the warp), prefetches the
// next four, gathers the four x values, then adds the four products in
// slot order -- the same fused multiply-adds in the same order as one slot
// at a time, so a row's sum and its bits do not change.  The grid is sized
// to the operator (256-, 128- or 64-thread blocks, the largest that gives
// every SM at least four), so a small operator still spreads over the
// card.  RCM ordering keeps a slice's columns close, so the gathers of x
// hit few cache lines.
//
// Contract.  One thread per row, for rows [0, n_out).  Columns are int32.
// Values are stored as V (int8, bfloat16 or float, as the TPU kernel stores
// them, or double for operators that keep f64 coefficients); x, y and the
// accumulator are T (float or double) with sizeof(V) <= sizeof(T).  Each
// value converts to T before its product (values.cuh), as the TPU kernel
// converts it to float32.  A column >= n_x reads x as 0, so an input shorter
// than the operator's input space is zero-extended.  Empty and padding rows
// give y = 0.  The launch allocates nothing, runs on the caller's stream
// and does not synchronise; each entry point returns cudaGetLastError(),
// or cudaErrorInvalidValue for a block size it does not take.

#include <cuda_runtime.h>
#include <cstdint>

#include "values.cuh"

namespace {

constexpr int kSlice = 32;
constexpr int kMaxBlock = 256;
constexpr int kFlight = 4;  // slots of a row in flight per thread
constexpr int64_t kStep = kSlice * kFlight;  // slot positions per step

// Four slots of one lane, 32 apart from position k: their columns and
// values; those at or past `end` are padding (column -1, value 0).
template <typename V>
struct Slots {
  int32_t c[kFlight];
  V v[kFlight];
};

template <typename V>
__device__ __forceinline__ Slots<V> load_slots(const int32_t* __restrict__ cols,
                                               const V* __restrict__ vals,
                                               int64_t k, int64_t end) {
  Slots<V> s;
#pragma unroll
  for (int u = 0; u < kFlight; ++u) {
    const int64_t q = k + static_cast<int64_t>(kSlice) * u;
    const bool live = q < end;
    s.c[u] = live ? __ldg(cols + q) : -1;
    s.v[u] = live ? __ldg(vals + q) : V{};
  }
  return s;
}

template <typename T> __device__ __forceinline__ T to_t(int8_t v) {
  return static_cast<T>(ddps::int8_to_float<false>(v));
}
template <typename T> __device__ __forceinline__ T to_t(__nv_bfloat16 v) {
  return static_cast<T>(__bfloat162float(v));
}
template <typename T> __device__ __forceinline__ T to_t(float v) {
  return static_cast<T>(v);
}
template <typename T> __device__ __forceinline__ T to_t(double v) {
  return static_cast<T>(v);
}

// a * b + c rounded once: the fused multiply-add the compiler makes of the
// first design's `acc += v * x`.
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename V, typename T>
__global__ void __launch_bounds__(kMaxBlock)
sell_spmv_kernel(const int64_t* __restrict__ slice_ptr,
                 const int32_t* __restrict__ cols,
                 const V* __restrict__ vals,
                 const T* __restrict__ x,
                 T* __restrict__ y,
                 int64_t n_out,
                 int64_t n_x) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (row >= n_out) return;
  const int64_t s = row / kSlice;
  const int lane = static_cast<int>(row % kSlice);
  const int64_t end = __ldg(slice_ptr + s + 1);
  int64_t k = __ldg(slice_ptr + s) + lane;
  T acc = T(0);
  if (k < end) {
    Slots<V> cur = load_slots(cols, vals, k, end);
    for (;;) {
      // Prefetch the next step's columns and values before this step's
      // gathers, so two steps' loads overlap.
      const int64_t kn = k + kStep;
      const bool more = kn < end;
      Slots<V> nxt;
      if (more) nxt = load_slots(cols, vals, kn, end);
      T xv[kFlight];
#pragma unroll
      for (int u = 0; u < kFlight; ++u) {
        const int32_t c = cur.c[u];
        xv[u] = (c >= 0 && c < n_x) ? __ldg(x + c) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kFlight; ++u) {
        acc = fma_rn(to_t<T>(cur.v[u]), xv[u], acc);
      }
      if (!more) break;
      cur = nxt;
      k = kn;
    }
  }
  y[row] = acc;
}

template <typename V, typename T>
int launch(const void* slice_ptr, const void* cols, const void* vals,
           const void* x, void* y, int64_t n_out, int64_t n_x, int block,
           void* stream) {
  if (block != 64 && block != 128 && block != kMaxBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_out > 0) {
    const unsigned blocks = static_cast<unsigned>((n_out + block - 1) / block);
    sell_spmv_kernel<V, T><<<blocks, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(slice_ptr),
        static_cast<const int32_t*>(cols), static_cast<const V*>(vals),
        static_cast<const T*>(x), static_cast<T*>(y), n_out, n_x);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DDPS_SELL_ENTRY(NAME, V, T)                                          \
  int NAME(const void* slice_ptr, const void* cols, const void* vals,      \
           const void* x, void* y, int64_t n_out, int64_t n_x, int block,  \
           void* stream) {                                                  \
    return launch<V, T>(slice_ptr, cols, vals, x, y, n_out, n_x, block,    \
                        stream);                                            \
  }

extern "C" {

// Storage float, vectors float (every operator of the f32 solve) or double
// (float-stored operators in an f64 solve).
DDPS_SELL_ENTRY(ddps_sell_spmv_f32_f32, float, float)
DDPS_SELL_ENTRY(ddps_sell_spmv_f32_f64, float, double)
// Storage double, vectors double (operators that keep f64 coefficients).
DDPS_SELL_ENTRY(ddps_sell_spmv_f64_f64, double, double)
// Storage int8 or bfloat16 (JAX's storage="auto" for integer-valued and
// bfloat16-exact operators), vectors float or double.
DDPS_SELL_ENTRY(ddps_sell_spmv_i8_f32, int8_t, float)
DDPS_SELL_ENTRY(ddps_sell_spmv_i8_f64, int8_t, double)
DDPS_SELL_ENTRY(ddps_sell_spmv_bf16_f32, __nv_bfloat16, float)
DDPS_SELL_ENTRY(ddps_sell_spmv_bf16_f64, __nv_bfloat16, double)

// A launch that cannot run (bad configuration) is reported here rather than
// at the next synchronisation.
const char* ddps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
