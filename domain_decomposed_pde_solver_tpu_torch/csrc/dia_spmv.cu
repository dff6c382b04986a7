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
// Bound.  By bytes the product is far below the card's ridge point: it
// reads ndiags * n coefficients (2 B in bfloat16 storage, 4 B in float, 8 B
// in double) and x, writes y, and does two flops per coefficient.  But the
// operators of the AMG hierarchy's DIA levels are small (4,920 rows at
// level 1 of the 1M box: 0.12 us of bytes), so there the product is bound
// by latency: the launch's ramp and one thread's chain of dependent loads.
// The design's answers:
//   - Compile-time diagonal counts.  The 19-diagonal (TETRA4), 27-diagonal
//     (HEX8) and 23-diagonal (level 2 of the TETRA4 box's brick
//     hierarchy) operators are template instances: the unrolled body
//     issues every coefficient and x load of a row before its first
//     multiply-add, so a row costs one load round trip, not ndiags.  Any
//     other count runs the run-time loop.
//   - No bounds test in the interior.  A block whose rows plus
//     [min off, max off] lie inside [0, n) reads x unchecked; edge blocks
//     keep the test.  The offsets travel in the __grid_constant__
//     parameter block (the constant bank), read uniformly by every thread.
//   - A launch shape from the size.  The caller picks the block (32 to 256
//     threads, one row per thread) from the operator's size
//     (ops/_kernels.py::dia_launch_shape).
// Every instance and block adds a row's products in ascending d, one fused
// multiply-add each, starting from 0: all give bit-identical results.
//
// Contract.  data is (ndiags, n) row-major, storage S (bfloat16 bits as
// uint16, float or double); x, y and the accumulator are T (float or double)
// with S no wider than T; each coefficient is upcast before its multiply.
// The launch
// allocates nothing, runs on the caller's stream and does not synchronise;
// each entry point returns cudaGetLastError().
//
// Measurement entries (never called by the port): ddps_dia_floor_noop
// launches a kernel that does nothing, and ddps_dia_floor_copy_* one that
// copies n values of x to y, each on the grid and block of a product of n
// rows, so that a product's time can be read beside its launch floor and
// one dependent load.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxBlock = 256;
constexpr int kMaxDiags = 128;

// ND > 0: a compiled diagonal count; ND == 0: the run-time loop, up to
// kMaxDiags offsets.  lo and hi bound the rows whose every tap lies inside
// [0, n): lo = max(0, -min off), hi = min(n, n - max off).
template <int ND>
struct DiaParams {
  int64_t off[ND > 0 ? ND : kMaxDiags];
  int64_t lo;
  int64_t hi;
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

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// A row inside [0, n) whose every tap is in range: no test.  The compiled
// instances issue every load before the first multiply-add.
template <typename S, typename T, int ND>
__device__ __forceinline__ void row_interior(const S* __restrict__ data,
                                             const T* __restrict__ x,
                                             T* __restrict__ y, int64_t n,
                                             int64_t i,
                                             const DiaParams<ND>& p) {
  T acc = T(0);
  if constexpr (ND > 0) {
    T a[ND];
    T v[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      a[d] = static_cast<T>(load_coef(data, static_cast<int64_t>(d) * n + i));
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) v[d] = __ldg(x + i + p.off[d]);
    // Keep every load above the first multiply-add: without this fence the
    // compiler interleaves them and holds a row to several round trips.
    asm volatile("" ::: "memory");
#pragma unroll
    for (int d = 0; d < ND; ++d) acc = fma_t(a[d], v[d], acc);
  } else {
    for (int d = 0; d < p.nd; ++d) {
      const T a = static_cast<T>(load_coef(data, static_cast<int64_t>(d) * n + i));
      acc = fma_t(a, __ldg(x + i + p.off[d]), acc);
    }
  }
  y[i] = acc;
}

// A row near either end: each tap tested.
template <typename S, typename T, int ND>
__device__ __forceinline__ void row_edge(const S* __restrict__ data,
                                         const T* __restrict__ x,
                                         T* __restrict__ y, int64_t n,
                                         int64_t i, const DiaParams<ND>& p) {
  T acc = T(0);
  // A compile-time trip count for the instances, p.nd for the loop.
#pragma unroll
  for (int d = 0; d < (ND > 0 ? ND : p.nd); ++d) {
    const int64_t j = i + p.off[d];
    const T a = static_cast<T>(load_coef(data, static_cast<int64_t>(d) * n + i));
    const T xv = (j >= 0 && j < n) ? __ldg(x + j) : T(0);
    acc = fma_t(a, xv, acc);
  }
  y[i] = acc;
}

template <typename S, typename T, int ND>
__global__ void __launch_bounds__(kMaxBlock)
dia_spmv_kernel(const S* __restrict__ data, const T* __restrict__ x,
                T* __restrict__ y, int64_t n,
                const __grid_constant__ DiaParams<ND> p) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t i = r0 + threadIdx.x;
  if (r0 >= p.lo && r0 + blockDim.x <= p.hi) {
    row_interior<S, T, ND>(data, x, y, n, i, p);
  } else if (i < n) {
    row_edge<S, T, ND>(data, x, y, n, i, p);
  }
}

bool valid_block(int block) {
  return block == 32 || block == 64 || block == 128 || block == 256;
}

unsigned grid_of(int64_t n, int block) {
  return static_cast<unsigned>((n + block - 1) / block);
}

template <typename S, typename T, int ND>
cudaError_t launch_instance(const S* data, const int64_t* off, int nd,
                            const T* x, T* y, int64_t n, int block,
                            cudaStream_t stream) {
  DiaParams<ND> p;
  int64_t mn = off[0], mx = off[0];
  for (int d = 0; d < nd; ++d) {
    p.off[d] = off[d];
    mn = off[d] < mn ? off[d] : mn;
    mx = off[d] > mx ? off[d] : mx;
  }
  p.nd = nd;
  p.lo = mn < 0 ? -mn : 0;
  p.hi = mx > 0 ? n - mx : n;
  dia_spmv_kernel<S, T, ND><<<grid_of(n, block), block, 0, stream>>>(
      data, x, y, n, p);
  return cudaGetLastError();
}

// instance: the compiled diagonal count to run (19, 23 or 27, equal to nd)
// or 0 for the run-time loop.
template <typename S, typename T>
int launch(const void* data, const void* offsets, int nd, const void* x,
           void* y, int64_t n, int block, int instance, void* stream) {
  if (nd < 1 || nd > kMaxDiags || !valid_block(block) ||
      (instance != 0 && instance != nd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const S* d = static_cast<const S*>(data);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (instance) {
    case 19:
      return static_cast<int>(
          launch_instance<S, T, 19>(d, off, nd, xv, yv, n, block, s));
    case 23:
      return static_cast<int>(
          launch_instance<S, T, 23>(d, off, nd, xv, yv, n, block, s));
    case 27:
      return static_cast<int>(
          launch_instance<S, T, 27>(d, off, nd, xv, yv, n, block, s));
    case 0:
      return static_cast<int>(
          launch_instance<S, T, 0>(d, off, nd, xv, yv, n, block, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

__global__ void noop_kernel() {}

template <typename T>
__global__ void __launch_bounds__(kMaxBlock)
copy_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __ldg(x + i);
}

template <typename T>
int launch_copy(const void* x, void* y, int64_t n, int block, void* stream) {
  if (!valid_block(block)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    copy_kernel<T><<<grid_of(n, block), block, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// offsets: a host array of nd int64 offsets; block: 32, 64, 128 or 256
// threads; instance: 19, 23, 27 (== nd) or 0.
#define DDPS_DIA_ENTRY(NAME, S, T)                                           \
  int NAME(const void* data, const void* offsets, int nd, const void* x,     \
           void* y, int64_t n, int block, int instance, void* stream) {      \
    return launch<S, T>(data, offsets, nd, x, y, n, block, instance,         \
                        stream);                                             \
  }

DDPS_DIA_ENTRY(ddps_dia_spmv_bf16_f32, uint16_t, float)
DDPS_DIA_ENTRY(ddps_dia_spmv_f32_f32, float, float)
DDPS_DIA_ENTRY(ddps_dia_spmv_bf16_f64, uint16_t, double)
DDPS_DIA_ENTRY(ddps_dia_spmv_f32_f64, float, double)
DDPS_DIA_ENTRY(ddps_dia_spmv_f64_f64, double, double)

#undef DDPS_DIA_ENTRY

// Measurement entries: the launch floor and one dependent load of a
// product of n rows in blocks of `block` threads.
int ddps_dia_floor_noop(int64_t n, int block, void* stream) {
  if (!valid_block(block)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    noop_kernel<<<grid_of(n, block), block, 0,
                  static_cast<cudaStream_t>(stream)>>>();
  }
  return static_cast<int>(cudaGetLastError());
}

int ddps_dia_floor_copy_f32(const void* x, void* y, int64_t n, int block,
                            void* stream) {
  return launch_copy<float>(x, y, n, block, stream);
}

int ddps_dia_floor_copy_f64(const void* x, void* y, int64_t n, int block,
                            void* stream) {
  return launch_copy<double>(x, y, n, block, stream);
}

const char* ddps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
