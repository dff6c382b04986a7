// DIA sparse matrix-vector product y = A x for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
// domain_decomposed_pde_solver_tpu/ops/pallas/dia_kernel.py::_kernel (launched
// by dia_spmv_pallas), which computes exactly DIAMatrix.matvec:
//
//     y[i] = sum_d data[d, i] * x[i + off[d]],   x read as 0 outside [0, n)
//
// The TPU kernel splits each shift into a row window and a static lane
// rotation because Mosaic cannot load at unaligned 1-D offsets; a GPU thread
// loads any address, so none of that is carried over.
//
// Bound.  On this card the product is bound by bytes: it reads ndiags * n
// coefficients (2 B in bfloat16 storage, 4 B in float, 8 B in double) and x,
// writes y, and does two flops per coefficient.  For the structured heat
// operators (19 to 27 diagonals) that is under one flop per byte, far below
// the H100's ridge point.  The design's answer is coalescing: one thread per
// row, so at diagonal d a warp reads 32 consecutive coefficients of data[d]
// and 32 consecutive x[i + off[d]]; the x reads of neighbouring diagonals hit
// the same cache lines, so x comes from L1/L2, not from device memory, after
// its first touch.  The offsets travel in the kernel's parameter block (the
// constant bank), read uniformly by every thread.
//
// Contract.  data is (ndiags, n) row-major, storage S (bfloat16 bits as
// uint16, float or double); x, y and the accumulator are T (float or double)
// with S no wider than T; each coefficient is upcast before its multiply.
// The launch allocates nothing, runs on the caller's stream and does not
// synchronise; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxDiags = 128;

struct DiaParams {
  int64_t off[kMaxDiags];
  int nd;
};

__device__ __forceinline__ float load_coef(const uint16_t* p, int64_t k) {
  // bfloat16 is the top half of a float32.
  return __uint_as_float(static_cast<unsigned>(__ldg(p + k)) << 16);
}
__device__ __forceinline__ float load_coef(const float* p, int64_t k) {
  return __ldg(p + k);
}
__device__ __forceinline__ double load_coef(const double* p, int64_t k) {
  return __ldg(p + k);
}

template <typename S, typename T>
__global__ void __launch_bounds__(kBlock)
dia_spmv_kernel(const S* __restrict__ data, const T* __restrict__ x,
                T* __restrict__ y, int64_t n,
                const __grid_constant__ DiaParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  T acc = T(0);
  for (int d = 0; d < p.nd; ++d) {
    const int64_t j = i + p.off[d];
    const T a = static_cast<T>(load_coef(data, static_cast<int64_t>(d) * n + i));
    const T xv = (j >= 0 && j < n) ? __ldg(x + j) : T(0);
    acc += a * xv;
  }
  y[i] = acc;
}

template <typename S, typename T>
int launch(const void* data, const void* offsets, int nd, const void* x,
           void* y, int64_t n, void* stream) {
  if (nd < 1 || nd > kMaxDiags) return static_cast<int>(cudaErrorInvalidValue);
  DiaParams p;
  const int64_t* off = static_cast<const int64_t*>(offsets);
  for (int d = 0; d < nd; ++d) p.off[d] = off[d];
  p.nd = nd;
  if (n > 0) {
    const int64_t blocks = (n + kBlock - 1) / kBlock;
    dia_spmv_kernel<S, T><<<static_cast<unsigned>(blocks), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const S*>(data), static_cast<const T*>(x),
        static_cast<T*>(y), n, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// offsets: a host array of nd int64 offsets.
int ddps_dia_spmv_bf16_f32(const void* data, const void* offsets, int nd,
                           const void* x, void* y, int64_t n, void* stream) {
  return launch<uint16_t, float>(data, offsets, nd, x, y, n, stream);
}

int ddps_dia_spmv_f32_f32(const void* data, const void* offsets, int nd,
                          const void* x, void* y, int64_t n, void* stream) {
  return launch<float, float>(data, offsets, nd, x, y, n, stream);
}

int ddps_dia_spmv_bf16_f64(const void* data, const void* offsets, int nd,
                           const void* x, void* y, int64_t n, void* stream) {
  return launch<uint16_t, double>(data, offsets, nd, x, y, n, stream);
}

int ddps_dia_spmv_f32_f64(const void* data, const void* offsets, int nd,
                          const void* x, void* y, int64_t n, void* stream) {
  return launch<float, double>(data, offsets, nd, x, y, n, stream);
}

int ddps_dia_spmv_f64_f64(const void* data, const void* offsets, int nd,
                          const void* x, void* y, int64_t n, void* stream) {
  return launch<double, double>(data, offsets, nd, x, y, n, stream);
}

const char* ddps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
