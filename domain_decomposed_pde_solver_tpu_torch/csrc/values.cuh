// Stored operator values, widened to the type a product computes in.
//
// The TPU kernels store BSG values as int8, bfloat16 or float32 and convert
// each to float32 before its product (domain_decomposed_pde_solver_tpu/ops/
// bsg.py::_spmv_kernel and solvers/fused_cg.py::_kernel:
// vals.astype(float32)).  The port's sliced-ELL kernels (csrc/spmv.cu,
// csrc/sell_chunked_spmv.cu, csrc/fused_cg.cu) do the same through
// load_value<T> (from device memory) and widen<T> (from shared memory): an
// int8 or bfloat16 value converts to T exactly, so an operator whose values
// all fit the narrow type gives the float32-stored launch's result bit for
// bit (the same products, in the same order).
//
// An int8 value converts in one of two exact ways, chosen per kernel by the
// kBias template argument: the integer-to-float instruction (the default),
// or a float bias -- 1.5 * 2^23 has a last place of 1, so adding the value
// to its bits and subtracting it again gives the value, with an integer add
// and a float subtract in place of the quarter-rate conversion.  On the
// H100 the fused CG kernel ran 15 % faster with the bias at 833k rows, the
// standalone products about 4 % slower (chip_smoke.py phase E, each beside
// the same slots with float values; PERF.md), so only csrc/fused_cg.cu asks
// for it.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace ddps {

template <bool kBias>
__device__ __forceinline__ float int8_to_float(int8_t v) {
  if constexpr (kBias) {
    return __int_as_float(0x4B400000 + static_cast<int>(v)) - 12582912.0f;
  } else {
    return static_cast<float>(v);
  }
}

template <typename T, bool kBias = false>
__device__ __forceinline__ T load_value(const float* p) {
  return static_cast<T>(__ldg(p));
}
template <typename T, bool kBias = false>
__device__ __forceinline__ T load_value(const double* p) {
  return static_cast<T>(__ldg(p));
}
template <typename T, bool kBias = false>
__device__ __forceinline__ T load_value(const int8_t* p) {
  return static_cast<T>(int8_to_float<kBias>(__ldg(p)));
}
template <typename T, bool kBias = false>
__device__ __forceinline__ T load_value(const __nv_bfloat16* p) {
  return static_cast<T>(__bfloat162float(__ldg(p)));
}

template <typename T, bool kBias = false>
__device__ __forceinline__ T widen(float v) {
  return static_cast<T>(v);
}
template <typename T, bool kBias = false>
__device__ __forceinline__ T widen(int8_t v) {
  return static_cast<T>(int8_to_float<kBias>(v));
}
template <typename T, bool kBias = false>
__device__ __forceinline__ T widen(__nv_bfloat16 v) {
  return static_cast<T>(__bfloat162float(v));
}

}  // namespace ddps
