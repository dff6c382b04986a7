// Jacobi-preconditioned conjugate gradient, the whole solve in one launch, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel domain_decomposed_pde_solver_tpu/solvers/fused_cg.py::
// _kernel (launched by _fused_cg): the Krylov loop -- matvec, dots, axpys and
// the convergence test -- inside one pallas_call on a VMEM-resident dense BSG
// operator, so that a solve costs one dispatch.  On the TPU the grid is one
// step and the loop runs on one core.  On Hopper the same job needs every SM,
// so this is a persistent cooperative kernel: cudaLaunchCooperativeKernel
// puts every block of the grid on the card at once (the grid is sized from
// the occupancy calculator, never larger), and the blocks meet at grid-wide
// barriers (cooperative_groups::this_grid().sync()).
//
// One iteration, three barriers (z = D^-1 r is never stored):
//   1. Ap = A p (sliced ELL, one thread per row, grid-stride over rows) and
//      the block's share of p.Ap;                                   barrier
//   2. every block sums the shares -> alpha = rz / pAp; x += alpha p,
//      r -= alpha Ap, and the shares of r.z and r.r;                 barrier
//   3. every block sums them -> rz', rnorm2, beta = rz' / rz;
//      p = D^-1 r + beta p;                                          barrier
// The stopping test is JAX's, on squared norms: continue while
// rnorm2 > tol2 * bnorm2 and k < maxiter, with bnorm2 = 1 when b = 0 and
// tol2 = tol^2 rounded to float once on the host, as JAX rounds it.
//
// Reductions.  Each thread sums its rows in float (the recurrence's type, as
// on the TPU); a block reduces its threads in double in a fixed tree and
// writes one partial per block.  After the barrier every block sums all
// partials in the same fixed order (lane l of warp 0 takes partials l, l+32,
// ...; then a fixed shuffle tree; lane 0's value is broadcast), so every
// block sees identical scalars, all blocks stop at the same iteration, and
// two runs on one card are bit-identical.  No atomics.  The setup, step 1
// and step 2 write separate partial regions, so no block overwrites
// partials another block may still be reading.
//
// Memory.  Vectors written during the solve (x, r, p, Ap) are read with
// plain loads, never the read-only cache; the barrier orders the writes of
// one step before the reads of the next.  The operator (slice_ptr, cols,
// vals), b and D^-1 go through __ldg.
//
// Bound.  Bytes: each iteration streams the operator once (slots x 8 B, the
// same 129 MB as csrc/spmv.cu at 833k rows) plus about nine vector passes
// (write Ap; read and write x, r, p; read D^-1 and Ap).  Operators that fit
// the 50 MB L2 cache are instead bound by the three barriers per iteration.
//
// Contract.  float storage, float vectors (the JAX kernel's f32 contract),
// square operator with every column < n.  The caller passes x holding x0
// (updated in place), r, p and Ap of n floats, the partials (6 doubles for
// each of up to max_blocks blocks; SMs x 2048 / kBlock always suffices) and
// a stats buffer of 4 doubles: iterations, relres = sqrt(rnorm2 / bnorm2),
// converged (1 or 0), rnorm2.  The launch sizes the grid itself, allocates
// nothing, runs on the caller's stream, does not synchronise, and returns the
// launch's error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

__device__ __forceinline__ float row_dot(const int64_t* __restrict__ slice_ptr,
                                         const int32_t* __restrict__ cols,
                                         const float* __restrict__ vals,
                                         const float* v, int64_t row) {
  const int64_t s = row >> 5;
  const int lane = static_cast<int>(row & 31);
  const int64_t end = __ldg(slice_ptr + s + 1);
  float acc = 0.f;
  for (int64_t k = __ldg(slice_ptr + s) + lane; k < end; k += 32) {
    acc += __ldg(vals + k) * v[__ldg(cols + k)];
  }
  return acc;
}

// Sum NV values over the block in a fixed tree; thread 0 writes them to
// out[0..NV).
template <int NV>
__device__ __forceinline__ void block_partials(const float (&v)[NV],
                                               double* out) {
  __shared__ double warp_sum[kWarps][NV];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    double s = static_cast<double>(v[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) warp_sum[warp][i] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += warp_sum[w][i];
      out[i] = s;
    }
  }
  __syncthreads();
}

// Sum the grid's partials (NV per block, block-major) in a fixed order; the
// result lands in tot[0..NV) for every thread of the block.
template <int NV>
__device__ __forceinline__ void grid_totals(const double* part, int n_blocks,
                                            double (&tot)[NV]) {
  __shared__ double shared_tot[NV];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      double s = 0.0;
      for (int b = lane; b < n_blocks; b += 32) s += part[b * NV + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, off);
      }
      s = __shfl_sync(0xffffffffu, s, 0);
      if (lane == 0) shared_tot[i] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) tot[i] = shared_tot[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kBlock)
fused_cg_kernel(const int64_t* __restrict__ slice_ptr,
                const int32_t* __restrict__ cols,
                const float* __restrict__ vals,
                const float* __restrict__ b,
                const float* __restrict__ invd,
                float* x, float* r, float* p, float* ap,
                double* part, double* stats, int64_t n, int maxiter,
                float tol2) {
  cg::grid_group grid = cg::this_grid();
  const int n_blocks = gridDim.x;
  double* part0 = part;                 // setup: 3 per block
  double* part1 = part + 3 * n_blocks;  // step 1: 1 per block
  double* part2 = part + 4 * n_blocks;  // step 2: 2 per block
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(n_blocks) * kBlock;

  // r0 = b - A x0 ; p0 = z0 = D^-1 r0 ; b.b, r.z, r.r
  {
    float v[3] = {0.f, 0.f, 0.f};
    for (int64_t row = first; row < n; row += stride) {
      const float bv = __ldg(b + row);
      const float rv = bv - row_dot(slice_ptr, cols, vals, x, row);
      const float zv = __ldg(invd + row) * rv;
      r[row] = rv;
      p[row] = zv;
      v[0] += bv * bv;
      v[1] += rv * zv;
      v[2] += rv * rv;
    }
    block_partials<3>(v, part0 + 3 * blockIdx.x);
  }
  grid.sync();
  double tot3[3];
  grid_totals<3>(part0, n_blocks, tot3);
  const float b2 = static_cast<float>(tot3[0]);
  const float bnorm2 = (b2 == 0.f) ? 1.f : b2;
  const float target2 = tol2 * bnorm2;
  float rz = static_cast<float>(tot3[1]);
  float rnorm2 = static_cast<float>(tot3[2]);

  int k = 0;
  while (rnorm2 > target2 && k < maxiter) {
    {  // 1. Ap = A p ; p.Ap
      float v[1] = {0.f};
      for (int64_t row = first; row < n; row += stride) {
        const float a = row_dot(slice_ptr, cols, vals, p, row);
        ap[row] = a;
        v[0] += p[row] * a;
      }
      block_partials<1>(v, part1 + blockIdx.x);
    }
    grid.sync();
    double tot1[1];
    grid_totals<1>(part1, n_blocks, tot1);
    const float alpha = rz / static_cast<float>(tot1[0]);
    {  // 2. x += alpha p ; r -= alpha Ap ; r.z and r.r
      float v[2] = {0.f, 0.f};
      for (int64_t row = first; row < n; row += stride) {
        x[row] += alpha * p[row];
        const float rv = r[row] - alpha * ap[row];
        r[row] = rv;
        v[0] += rv * (__ldg(invd + row) * rv);
        v[1] += rv * rv;
      }
      block_partials<2>(v, part2 + 2 * blockIdx.x);
    }
    grid.sync();
    double tot2[2];
    grid_totals<2>(part2, n_blocks, tot2);
    const float rz_new = static_cast<float>(tot2[0]);
    rnorm2 = static_cast<float>(tot2[1]);
    const float beta = rz_new / rz;
    // 3. p = D^-1 r + beta p
    for (int64_t row = first; row < n; row += stride) {
      p[row] = __ldg(invd + row) * r[row] + beta * p[row];
    }
    rz = rz_new;
    ++k;
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    stats[0] = static_cast<double>(k);
    stats[1] = static_cast<double>(sqrtf(rnorm2 / bnorm2));
    stats[2] = (rnorm2 <= target2) ? 1.0 : 0.0;
    stats[3] = static_cast<double>(rnorm2);
  }
}

}  // namespace

extern "C" {

// The grid is every block that can be resident at once (occupancy x SMs), no
// more than the rows need, at least 1.  Returns cudaErrorNotSupported where
// the device has no cooperative launch, cudaErrorInvalidValue where the
// partials hold fewer than the grid's blocks.
int ddps_fused_cg_f32(const void* slice_ptr, const void* cols,
                      const void* vals, const void* b, const void* invd,
                      void* x, void* r, void* p, void* ap, void* part,
                      int64_t max_blocks, void* stats, int64_t n, int maxiter,
                      float tol2, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_cg_kernel,
                                                      kBlock, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int64_t grid = static_cast<int64_t>(per_sm) * sms;
  const int64_t need = (n + kBlock - 1) / kBlock;
  if (need < grid) grid = need;
  if (grid < 1) grid = 1;
  if (grid > max_blocks) return static_cast<int>(cudaErrorInvalidValue);

  const int64_t* a_slice_ptr = static_cast<const int64_t*>(slice_ptr);
  const int32_t* a_cols = static_cast<const int32_t*>(cols);
  const float* a_vals = static_cast<const float*>(vals);
  const float* a_b = static_cast<const float*>(b);
  const float* a_invd = static_cast<const float*>(invd);
  float* a_x = static_cast<float*>(x);
  float* a_r = static_cast<float*>(r);
  float* a_p = static_cast<float*>(p);
  float* a_ap = static_cast<float*>(ap);
  double* a_part = static_cast<double*>(part);
  double* a_stats = static_cast<double*>(stats);
  void* args[] = {&a_slice_ptr, &a_cols, &a_vals, &a_b, &a_invd, &a_x,
                  &a_r, &a_p, &a_ap, &a_part, &a_stats, &n, &maxiter, &tol2};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_cg_kernel),
      dim3(static_cast<unsigned>(grid)), dim3(kBlock), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* ddps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
