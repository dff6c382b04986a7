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
// slice_ptr[s] + 32*j + i.  Shorter rows are padded with (col 0, value 0).
//
// Bound.  On this card the kernel is bound by bytes, not operations: it reads
// slots x (4 B column + value bytes), gathers x once per slot, and writes y
// once per row, at two flops per slot.  Narrow values (int8: 1 B, bfloat16:
// 2 B, as the JAX packer stores the graph Laplacian) cut the value bytes.
// The 32-row slice is the design's answer to that bound: each warp reads its
// slice's column and value arrays as contiguous lines (neighbouring threads,
// neighbouring slots), and padding grows only to the widest row of 32
// neighbours, not of the whole matrix.  RCM ordering keeps a slice's columns
// close, so the gathers of x hit few cache lines.
//
// Contract.  One thread per row, for rows [0, n_out).  Columns are int32.
// Values are stored as V (int8, bfloat16 or float, as the TPU kernel stores
// them, or double for operators that keep the compute precision); x, y and
// the accumulator are T (float or double), with sizeof(V) <= sizeof(T).  A
// value converts to T before its product (values.cuh), as the TPU kernel
// converts it to float32.  A column >= n_x reads x as 0, so an input shorter
// than the operator's input space is zero-extended.  Empty and padding rows
// give y = 0.  The launch allocates nothing, runs on the caller's stream and
// does not synchronise; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

#include "values.cuh"

namespace {

constexpr int kSlice = 32;
constexpr int kBlock = 256;  // 8 slices per block

template <typename V, typename T>
__global__ void __launch_bounds__(kBlock)
sell_spmv_kernel(const int64_t* __restrict__ slice_ptr,
                 const int32_t* __restrict__ cols,
                 const V* __restrict__ vals,
                 const T* __restrict__ x,
                 T* __restrict__ y,
                 int64_t n_out,
                 int64_t n_x) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (row >= n_out) return;
  const int64_t s = row / kSlice;
  const int lane = static_cast<int>(row % kSlice);
  const int64_t end = __ldg(slice_ptr + s + 1);
  T acc = T(0);
  for (int64_t k = __ldg(slice_ptr + s) + lane; k < end; k += kSlice) {
    const int32_t c = __ldg(cols + k);
    const T xv = (c < n_x) ? __ldg(x + c) : T(0);
    acc += ddps::load_value<T>(vals + k) * xv;
  }
  y[row] = acc;
}

template <typename V, typename T>
int launch(const void* slice_ptr, const void* cols, const void* vals,
           const void* x, void* y, int64_t n_out, int64_t n_x, void* stream) {
  if (n_out > 0) {
    const int64_t blocks = (n_out + kBlock - 1) / kBlock;
    sell_spmv_kernel<V, T><<<static_cast<unsigned>(blocks), kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(slice_ptr),
        static_cast<const int32_t*>(cols), static_cast<const V*>(vals),
        static_cast<const T*>(x), static_cast<T*>(y), n_out, n_x);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Storage float, vectors float (every operator of the f32 solve).
int ddps_sell_spmv_f32_f32(const void* slice_ptr, const void* cols,
                           const void* vals, const void* x, void* y,
                           int64_t n_out, int64_t n_x, void* stream) {
  return launch<float, float>(slice_ptr, cols, vals, x, y, n_out, n_x, stream);
}

// Storage float, vectors double (float-stored operators in an f64 solve).
int ddps_sell_spmv_f32_f64(const void* slice_ptr, const void* cols,
                           const void* vals, const void* x, void* y,
                           int64_t n_out, int64_t n_x, void* stream) {
  return launch<float, double>(slice_ptr, cols, vals, x, y, n_out, n_x, stream);
}

// Storage double, vectors double (operators that keep f64 coefficients).
int ddps_sell_spmv_f64_f64(const void* slice_ptr, const void* cols,
                           const void* vals, const void* x, void* y,
                           int64_t n_out, int64_t n_x, void* stream) {
  return launch<double, double>(slice_ptr, cols, vals, x, y, n_out, n_x,
                                stream);
}

// Storage int8 or bfloat16 (JAX's storage="auto" for integer-valued and
// bfloat16-exact operators), vectors float or double.
int ddps_sell_spmv_i8_f32(const void* slice_ptr, const void* cols,
                          const void* vals, const void* x, void* y,
                          int64_t n_out, int64_t n_x, void* stream) {
  return launch<int8_t, float>(slice_ptr, cols, vals, x, y, n_out, n_x,
                               stream);
}
int ddps_sell_spmv_i8_f64(const void* slice_ptr, const void* cols,
                          const void* vals, const void* x, void* y,
                          int64_t n_out, int64_t n_x, void* stream) {
  return launch<int8_t, double>(slice_ptr, cols, vals, x, y, n_out, n_x,
                                stream);
}
int ddps_sell_spmv_bf16_f32(const void* slice_ptr, const void* cols,
                            const void* vals, const void* x, void* y,
                            int64_t n_out, int64_t n_x, void* stream) {
  return launch<__nv_bfloat16, float>(slice_ptr, cols, vals, x, y, n_out,
                                      n_x, stream);
}
int ddps_sell_spmv_bf16_f64(const void* slice_ptr, const void* cols,
                            const void* vals, const void* x, void* y,
                            int64_t n_out, int64_t n_x, void* stream) {
  return launch<__nv_bfloat16, double>(slice_ptr, cols, vals, x, y, n_out,
                                       n_x, stream);
}

// A launch that cannot run (bad configuration) is reported here rather than
// at the next synchronisation.
const char* ddps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
