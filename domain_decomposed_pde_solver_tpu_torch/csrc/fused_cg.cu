// Jacobi-preconditioned conjugate gradient, the whole solve in one launch, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel domain_decomposed_pde_solver_tpu/solvers/fused_cg.py::
// _kernel (launched by _fused_cg): the Krylov loop -- matvec, dots, axpys and
// the convergence test -- inside one pallas_call on a VMEM-resident dense BSG
// operator, so that a solve costs one dispatch and, after the first load, no
// device-memory traffic.  Two instances of the same recurrence:
//
// The grid instance (any size).  A persistent cooperative kernel:
// cudaLaunchCooperativeKernel puts every block of the grid on the card at
// once (the grid is sized from the occupancy calculator, never larger, and
// is the same for every value storage), and the blocks meet at grid-wide
// barriers (cooperative_groups::this_grid().sync()).  One iteration, three
// barriers (z = D^-1 r is never stored):
//   1. Ap = A p (sliced ELL, one thread per row, grid-stride over rows) and
//      the block's share of p.Ap;                                   barrier
//   2. every block sums the shares -> alpha = rz / pAp; x += alpha p,
//      r -= alpha Ap, and the shares of r.z and r.r;                 barrier
//   3. every block sums them -> rz', rnorm2, beta = rz' / rz;
//      p = D^-1 r + beta p;                                          barrier
// Bound: bytes.  Each iteration streams the operator once (slots x (4 B
// column + value bytes): 129 MB at 833k rows with float values, 80 MB with
// the int8 values JAX stores for the graph Laplacian) plus about nine vector
// passes.
//
// The cluster instance (operators that fit on chip: at most 16 x 1024
// rows).  What plays VMEM's part on Hopper for an operator of the size of
// the reference's meshes is the shared memory of a thread-block cluster:
// c = n / 1024 <= 16 CTAs of 1024 threads, one row per thread, launched
// with cudaLaunchKernelEx and a cluster dimension (16 is a non-portable
// size).  At the start each CTA copies its 1024 rows' slots into shared
// memory with cp.async: values as stored, columns as 16-bit indices into a
// window that covers every column its rows touch, widened to multiples of
// 4 rows (packed on the host, solvers/fused_cg.py::cluster_pack).  x, r, p, b and D^-1 of the thread's
// row live in registers; the CTA keeps p over its window.  The operator
// never leaves the chip, and no cluster barrier is left in the loop: with
// three cluster barriers per iteration (every thread of 16 CTAs arriving)
// the first design of this instance was slower than the grid instance, so
// the CTAs signal each other through mbarriers instead.  Every value another
// CTA needs is pushed into that CTA's shared memory with st.async, which
// counts its bytes on the receiver's mbarrier, and the receiver waits for
// the bytes it expects:
//   1. Ap = A p from the p window; p.Ap pushed to every CTA;        wait
//   2. alpha; x += alpha p, r -= alpha Ap; r.z, r.r pushed to every CTA,
//      then z = D^-1 r pushed into the windows that hold the row (four rows
//      in one 16-byte store), while the sums travel;                wait
//   3. beta; wait for the z window; p = z + beta p on the thread's row and
//      over the window, the same float operation, so every CTA holds its
//      neighbours' p exactly;                               __syncthreads
// A CTA can be at most one exchange ahead of another (it needs the other's
// sums to go on), so one buffer and one mbarrier per exchange suffice.
// Bound: latency -- the exchanges, the reductions and the matvec's chain
// of shared-memory loads -- not bytes; at 16k rows the compulsory bytes
// (operator and vectors once) are about 2.5 MB.
//
// The stopping test is JAX's in both, on squared norms: continue while
// rnorm2 > tol2 * bnorm2 and k < maxiter, with bnorm2 = 1 when b = 0 and
// tol2 = tol^2 rounded to float once on the host, as JAX rounds it.
//
// Reductions.  Each thread sums its rows in float (the recurrence's type, as
// on the TPU); a block reduces its threads in double in a fixed tree and
// publishes one partial per block.  After the barrier every block sums all
// partials in the same fixed order (the grid: lane l of warp 0 takes
// partials l, l+32, ... then a fixed shuffle tree; the cluster: every warp
// adds the c sums pushed into its CTA in a fixed butterfly), so every block
// sees identical scalars, all blocks stop at the same iteration, and two
// runs on one card are bit-identical.  No atomics.  Each reduction has its
// own partial slots, so no block overwrites partials another block may
// still be reading.
//
// Memory.  Vectors written during the grid solve (x, r, p, Ap) are read
// with plain loads, never the read-only cache; the barrier orders the
// writes of one step before the reads of the next.  The operator, b and
// D^-1 go through __ldg.
//
// Contract.  Values stored as int8, bfloat16 or float (the JAX kernel's
// storages; each converts to float before its product, values.cuh, as the
// TPU kernel converts it at fused_cg.py:50, so an exact narrow storage gives
// the float storage's solve bit for bit), float vectors (the JAX kernel's
// f32 contract), square operator with every column < n.  Grid: the caller
// passes x holding x0 (updated in place), r, p and Ap of n floats, the
// partials (6 doubles for each of up to max_blocks blocks; SMs x 2048 /
// kBlock always suffices).
// Cluster: n = 1024 c, x0 (or null for 0) and x may differ; the slots of
// CTA k are slice_ptr[32k] .. slice_ptr[32k + 32], win holds (lo, width) of
// each CTA's window.  Both write a stats buffer of 4 doubles: iterations,
// relres = sqrt(rnorm2 / bnorm2), converged (1 or 0), rnorm2.  The launch
// allocates nothing, runs on the caller's stream, does not synchronise, and
// returns the launch's error code.
//
// Measurement entries (never called by the port), in the same launches:
// mode 0 keeps only the barriers and the reductions of every iteration
// (the synchronisation floor), mode 1 adds the matvec (with the cluster's
// operator copy and window exchanges), mode 2 is the solve.  Modes 0 and 1 run
// exactly maxiter iterations.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "values.cuh"

namespace cg = cooperative_groups;

namespace {

enum Mode : int { kSkeleton = 0, kMatvec = 1, kFull = 2 };

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// int8 values convert through the float bias (values.cuh): this kernel ran
// 15 % faster with it at 833k rows on the H100.
constexpr bool kBias = true;

template <typename V>
__device__ __forceinline__ float row_dot(const int64_t* __restrict__ slice_ptr,
                                         const int32_t* __restrict__ cols,
                                         const V* __restrict__ vals,
                                         const float* v, int64_t row) {
  const int64_t s = row >> 5;
  const int lane = static_cast<int>(row & 31);
  const int64_t end = __ldg(slice_ptr + s + 1);
  float acc = 0.f;
  for (int64_t k = __ldg(slice_ptr + s) + lane; k < end; k += 32) {
    acc += ddps::load_value<float, kBias>(vals + k) * v[__ldg(cols + k)];
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

template <int M, typename V>
__global__ void __launch_bounds__(kBlock)
fused_cg_kernel(const int64_t* __restrict__ slice_ptr,
                const int32_t* __restrict__ cols,
                const V* __restrict__ vals,
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
    if constexpr (M != kSkeleton) {
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
  while ((M != kFull || rnorm2 > target2) && k < maxiter) {
    {  // 1. Ap = A p ; p.Ap
      float v[1] = {0.f};
      if constexpr (M != kSkeleton) {
        for (int64_t row = first; row < n; row += stride) {
          const float a = row_dot(slice_ptr, cols, vals, p, row);
          ap[row] = a;
          v[0] += p[row] * a;
        }
      }
      block_partials<1>(v, part1 + blockIdx.x);
    }
    grid.sync();
    double tot1[1];
    grid_totals<1>(part1, n_blocks, tot1);
    const float alpha = rz / static_cast<float>(tot1[0]);
    {  // 2. x += alpha p ; r -= alpha Ap ; r.z and r.r
      float v[2] = {0.f, 0.f};
      if constexpr (M == kFull) {
        for (int64_t row = first; row < n; row += stride) {
          x[row] += alpha * p[row];
          const float rv = r[row] - alpha * ap[row];
          r[row] = rv;
          v[0] += rv * (__ldg(invd + row) * rv);
          v[1] += rv * rv;
        }
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
    if constexpr (M == kFull) {
      for (int64_t row = first; row < n; row += stride) {
        p[row] = __ldg(invd + row) * r[row] + beta * p[row];
      }
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

// ---------------------------------------------------------------------------
// The cluster instance
// ---------------------------------------------------------------------------

// The layout's constants come from the build (ops/_kernels.py defines them
// once, for this source and for the instance rule that admits operators).
#if !defined(DDPS_CLUSTER_CTA_ROWS) || !defined(DDPS_CLUSTER_MAX_CTAS) ||  \
    !defined(DDPS_CLUSTER_MAX_WINDOW) || !defined(DDPS_CLUSTER_SMEM_BUDGET) || \
    !defined(DDPS_CLUSTER_SMEM_TAIL)
#error "build with -DDDPS_CLUSTER_* (ops/_kernels.py passes them)"
#endif
constexpr int kCta = DDPS_CLUSTER_CTA_ROWS;  // threads, and rows, per CTA
constexpr int kCtaWarps = kCta / 32;  // = the CTA's 32-row slices
constexpr int kMaxCtas = DDPS_CLUSTER_MAX_CTAS;
constexpr int kMaxWindow = DDPS_CLUSTER_MAX_WINDOW;  // 16-bit local columns
constexpr int64_t kSmemBudget = DDPS_CLUSTER_SMEM_BUDGET;  // opt-in maximum
constexpr int kPartRegions = 6;  // b.b, r.z, r.r (set-up); p.Ap; r.z, r.r
constexpr int kBars = 5;  // x0 window, r window, set-up, p.Ap, r.z + r.r
static_assert(kCtaWarps == 32, "warp 0 reduces one sum of each warp");
static_assert(kMaxCtas <= 32 && (kMaxCtas & (kMaxCtas - 1)) == 0,
              "lane l of a warp adds the sum of CTA l % kMaxCtas");
static_assert(kMaxWindow <= 1 << 16, "local columns are 16-bit");

__host__ __device__ constexpr int64_t align16(int64_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Dynamic shared memory of a CTA, in this order: slot values (as stored: 1,
// 2 or 4 bytes), slot columns (uint16), two windows (float: z = D^-1 r as
// pushed by its owners, and p), then the tail: the partials pushed by the
// cluster's CTAs (double, kPartRegions x kMaxCtas), 32 warps x 3 warp sums
// (double), the mbarriers (8 B each, 64 B), every CTA's window start (int).
constexpr int64_t kSmemTail =
    8 * kPartRegions * kMaxCtas + 8 * 3 * kCtaWarps + 64 + 4 * kMaxCtas;
static_assert(kSmemTail == DDPS_CLUSTER_SMEM_TAIL,
              "the shared-memory tail differs from ops/_kernels.py's");
template <typename V>
__host__ __device__ constexpr int64_t cluster_smem_bytes(int64_t max_slots,
                                                         int64_t max_win) {
  return align16((static_cast<int64_t>(sizeof(V)) + 2) * max_slots) +
         2 * align16(4 * max_win) + kSmemTail;
}

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of the same shared-memory object in CTA rank.
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// Asynchronous stores into another CTA's shared memory that count their
// bytes on that CTA's mbarrier (its transaction count).
__device__ __forceinline__ void push_f32(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void push_f64(uint32_t addr, double v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "l"(__double_as_longlong(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}
// The CTA's one arrival of a phase, with the bytes the phase waits for.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One cluster-wide sum of NV values, in two halves so that other pushes can
// go out between them.  cluster_push: the CTA reduces its threads in a
// fixed tree (double) and warp 0 pushes the CTA's sums into slot `rank` of
// regions base .. base + NV - 1 of every CTA.  cluster_totals: the CTA
// waits on its own mbarrier for the c CTAs' sums and every warp adds them
// in a fixed butterfly (lane l takes slot l % 16; a + b == b + a, so every
// lane, warp and CTA holds the same totals).
template <int NV>
__device__ __forceinline__ void cluster_push(const float (&v)[NV],
                                             double* warp_sum, double* part,
                                             uint64_t* bar, int base,
                                             int rank, int c) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    double s = static_cast<double>(v[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) warp_sum[3 * warp + i] = s;
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) bar_expect(bar, static_cast<uint32_t>(8 * NV * c));
    double s[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      s[i] = warp_sum[3 * lane + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s[i] += __shfl_down_sync(0xffffffffu, s[i], off);
      }
      s[i] = __shfl_sync(0xffffffffu, s[i], 0);
    }
    if (lane < c) {
      const uint32_t rbar = remote(bar, lane);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        push_f64(remote(part + (base + i) * kMaxCtas + rank, lane), s[i],
                 rbar);
      }
    }
  }
}

template <int NV>
__device__ __forceinline__ void cluster_totals(const double* part,
                                               uint64_t* bar, uint32_t parity,
                                               int base, int c,
                                               double (&tot)[NV]) {
  bar_wait(bar, parity);
  const int slot = threadIdx.x & (kMaxCtas - 1);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    double s = slot < c ? part[(base + i) * kMaxCtas + slot] : 0.0;
#pragma unroll
    for (int m = kMaxCtas / 2; m > 0; m >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, m);
    }
    tot[i] = s;
  }
}

__device__ __forceinline__ void push_v4(uint32_t addr, float a, float b,
                                        float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(a)), "r"(__float_as_uint(b)),
      "r"(__float_as_uint(c)), "r"(__float_as_uint(d)), "r"(bar)
      : "memory");
}

// Push the rows' values into the window `win` of every CTA whose window
// holds them (the bits of `dest`), counted on that CTA's `bar`: lane 4q of
// a warp sends the values of lanes 4q .. 4q + 3 (rows g .. g + 3, g a
// multiple of 4) as one 16-byte store.  Windows start and end on multiples
// of 4 rows, so a window holds all four rows or none, and the four lanes
// share `dest`.  Every thread of the warp calls it.
__device__ __forceinline__ void push_rows(float v, int64_t g, unsigned dest,
                                          const int* lo, float* win,
                                          uint64_t* bar) {
  const float v1 = __shfl_down_sync(0xffffffffu, v, 1);
  const float v2 = __shfl_down_sync(0xffffffffu, v, 2);
  const float v3 = __shfl_down_sync(0xffffffffu, v, 3);
  if ((threadIdx.x & 3) == 0) {
    for (unsigned m = dest; m; m &= m - 1) {
      const int k = __ffs(m) - 1;
      push_v4(remote(win + (g - lo[k]), k), v, v1, v2, v3, remote(bar, k));
    }
  }
}

template <int M, typename V>
__global__ void __launch_bounds__(kCta, 1)
fused_cg_cluster_kernel(const V* __restrict__ vals,
                        const uint16_t* __restrict__ lcols,
                        const int64_t* __restrict__ slice_ptr,
                        const int32_t* __restrict__ windows,
                        const float* __restrict__ b,
                        const float* __restrict__ invd,
                        const float* __restrict__ x0, float* __restrict__ x,
                        double* __restrict__ stats, int max_slots,
                        int max_win, int maxiter, float tol2) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t wbytes = align16(4 * max_win);
  constexpr int kVb = static_cast<int>(sizeof(V));
  V* s_vals = reinterpret_cast<V*>(smem);
  uint16_t* s_cols = reinterpret_cast<uint16_t*>(smem + kVb * max_slots);
  unsigned char* w0 = smem + align16((kVb + 2) * max_slots);
  float* s_zwin = reinterpret_cast<float*>(w0);
  float* s_pwin = reinterpret_cast<float*>(w0 + wbytes);
  double* s_part = reinterpret_cast<double*>(w0 + 2 * wbytes);
  double* s_warp = s_part + kPartRegions * kMaxCtas;
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_warp + 3 * kCtaWarps);
  int* s_lo = reinterpret_cast<int*>(s_bar + 8);
  uint64_t* bar_x = s_bar;      // the x0 window (into s_pwin), once
  uint64_t* bar_z = s_bar + 1;  // the z window, every iteration
  uint64_t* bar_s = s_bar + 2;  // set-up sums
  uint64_t* bar_a = s_bar + 3;  // p.Ap
  uint64_t* bar_r = s_bar + 4;  // r.z, r.r

  if (tid == 0) {
    for (int i = 0; i < kBars; ++i) bar_init(s_bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < c) s_lo[tid] = __ldg(windows + 2 * tid);
  // The CTA's slots, contiguous from slot0 (a multiple of 32), into shared
  // memory; the warp's slice starts at my0 within them.
  const int64_t slice0 = static_cast<int64_t>(rank) * kCtaWarps;
  const int64_t slot0 = __ldg(slice_ptr + slice0);
  const int n_slots = static_cast<int>(__ldg(slice_ptr + slice0 + kCtaWarps) - slot0);
  const int wn = __ldg(windows + 2 * rank + 1);
  if constexpr (M != kSkeleton) {
    // n_slots is a multiple of 32, so the values are whole 16-byte pieces.
    const unsigned char* g_vals =
        reinterpret_cast<const unsigned char*>(vals + slot0);
    for (int k = tid; k < n_slots * kVb / 16; k += kCta) {
      copy16_async(reinterpret_cast<unsigned char*>(s_vals) + 16 * k,
                   g_vals + 16 * k);
    }
    for (int k = tid; k < n_slots / 8; k += kCta) {
      copy16_async(s_cols + 8 * k, lcols + slot0 + 8 * k);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const int my0 = static_cast<int>(__ldg(slice_ptr + slice0 + warp) - slot0);
  const int width = static_cast<int>(
      (__ldg(slice_ptr + slice0 + warp + 1) - slot0 - my0) >> 5);
  const int64_t row = static_cast<int64_t>(rank) * kCta + tid;
  const float bv = __ldg(b + row);
  const float dv = __ldg(invd + row);
  float xv = x0 ? __ldg(x0 + row) : 0.f;
  // The CTAs whose windows hold this row.
  unsigned dest = 0;
  for (int k = 0; k < c; ++k) {
    const int64_t j = row - __ldg(windows + 2 * k);
    if (j >= 0 && j < __ldg(windows + 2 * k + 1)) dest |= 1u << k;
  }
  // Every mbarrier of the cluster is initialised before the first push.
  cluster.sync();

  // Ap for the thread's row from the window, in the grid instance's order.
  auto row_dot_window = [&](const float* win) {
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < width; ++j) {
      const int k = my0 + 32 * j + lane;
      acc += ddps::widen<float, kBias>(s_vals[k]) * win[s_cols[k]];
    }
    return acc;
  };

  // r0 = b - A x0 ; p0 = z0 = D^-1 r0 ; b.b, r.z, r.r
  float ax = 0.f;
  if constexpr (M != kSkeleton) {
    if (tid == 0) bar_expect(bar_x, static_cast<uint32_t>(4 * wn));
    push_rows(xv, row, dest, s_lo, s_pwin, bar_x);
    bar_wait(bar_x, 0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    ax = row_dot_window(s_pwin);
  }
  float rv = bv - ax;
  float zv = __fmul_rn(dv, rv);
  float pv = zv;
  {
    float v[3] = {bv * bv, rv * zv, rv * rv};
    cluster_push<3>(v, s_warp, s_part, bar_s, 0, rank, c);
  }
  if constexpr (M != kSkeleton) {
    if (tid == 0) bar_expect(bar_z, static_cast<uint32_t>(4 * wn));
    push_rows(zv, row, dest, s_lo, s_zwin, bar_z);
  }
  double tot3[3];
  cluster_totals<3>(s_part, bar_s, 0, 0, c, tot3);
  const float b2 = static_cast<float>(tot3[0]);
  const float bnorm2 = (b2 == 0.f) ? 1.f : b2;
  const float target2 = tol2 * bnorm2;
  float rz = static_cast<float>(tot3[1]);
  float rnorm2 = static_cast<float>(tot3[2]);
  uint32_t phase = 0;  // of bar_z, bar_a and bar_r in the loop
  if constexpr (M != kSkeleton) {
    bar_wait(bar_z, 0);
    for (int j = tid; j < wn; j += kCta) s_pwin[j] = s_zwin[j];
    __syncthreads();
  }

  int k = 0;
  while ((M != kFull || rnorm2 > target2) && k < maxiter) {
    // 1. Ap = A p from the window ; p.Ap
    float a = 0.f;
    if constexpr (M != kSkeleton) a = row_dot_window(s_pwin);
    double tot1[1];
    {
      float v[1] = {pv * a};
      cluster_push<1>(v, s_warp, s_part, bar_a, 3, rank, c);
    }
    cluster_totals<1>(s_part, bar_a, phase, 3, c, tot1);
    const float alpha = rz / static_cast<float>(tot1[0]);
    // 2. x += alpha p ; r -= alpha Ap ; z = D^-1 r pushed into the windows
    // that hold the row while r.z and r.r are summed
    if constexpr (M == kFull) {
      xv += alpha * pv;
      rv = rv - alpha * a;
      zv = __fmul_rn(dv, rv);
    }
    {
      float v[2] = {rv * zv, rv * rv};
      cluster_push<2>(v, s_warp, s_part, bar_r, 4, rank, c);
    }
    if constexpr (M != kSkeleton) {
      if (tid == 0) bar_expect(bar_z, static_cast<uint32_t>(4 * wn));
      push_rows(zv, row, dest, s_lo, s_zwin, bar_z);
    }
    double tot2[2];
    cluster_totals<2>(s_part, bar_r, phase, 4, c, tot2);
    const float rz_new = static_cast<float>(tot2[0]);
    rnorm2 = static_cast<float>(tot2[1]);
    const float beta = rz_new / rz;
    // 3. p = z + beta p, on the thread's row and over the window (the same
    // float operation, so every CTA holds its neighbours' p exactly)
    if constexpr (M != kSkeleton) {
      bar_wait(bar_z, phase ^ 1);
      if constexpr (M == kFull) {
        for (int j = tid; j < wn; j += kCta) {
          s_pwin[j] = __fmaf_rn(beta, s_pwin[j], s_zwin[j]);
        }
      }
      __syncthreads();
    }
    if constexpr (M == kFull) pv = __fmaf_rn(beta, pv, zv);
    rz = rz_new;
    phase ^= 1;
    ++k;
  }
  x[row] = xv;
  if (rank == 0 && tid == 0) {
    stats[0] = static_cast<double>(k);
    stats[1] = static_cast<double>(sqrtf(rnorm2 / bnorm2));
    stats[2] = (rnorm2 <= target2) ? 1.0 : 0.0;
    stats[3] = static_cast<double>(rnorm2);
  }
  // No CTA leaves while another may still push into its shared memory.
  cluster.sync();
}

// Resident blocks per SM of the grid instance: the least over the value
// storages, so every storage runs the same grid.  The grid fixes the order
// in which the blocks' partial dots add up; with one grid for all, exact
// int8 or bfloat16 values give the float solve bit for bit (the
// instantiations differ in registers: 48 for float, 40 for int8 and
// bfloat16 on sm_90a, so each alone would fill the SMs differently).
template <int M>
cudaError_t grid_blocks_per_sm(int* per_sm) {
  int counts[3] = {0, 0, 0};
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &counts[0], fused_cg_kernel<M, float>, kBlock, 0);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &counts[1], fused_cg_kernel<M, int8_t>, kBlock, 0);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &counts[2], fused_cg_kernel<M, __nv_bfloat16>, kBlock, 0);
  }
  *per_sm = counts[0] < counts[1] ? counts[0] : counts[1];
  if (counts[2] < *per_sm) *per_sm = counts[2];
  return err;
}

template <int M, typename V>
int launch_grid(const void* slice_ptr, const void* cols, const void* vals,
                const void* b, const void* invd, void* x, void* r, void* p,
                void* ap, void* part, int64_t max_blocks, void* stats,
                int64_t n, int maxiter, float tol2, void* stream) {
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
  err = grid_blocks_per_sm<M>(&per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int64_t grid = static_cast<int64_t>(per_sm) * sms;
  const int64_t need = (n + kBlock - 1) / kBlock;
  if (need < grid) grid = need;
  if (grid < 1) grid = 1;
  if (grid > max_blocks) return static_cast<int>(cudaErrorInvalidValue);

  const int64_t* a_slice_ptr = static_cast<const int64_t*>(slice_ptr);
  const int32_t* a_cols = static_cast<const int32_t*>(cols);
  const V* a_vals = static_cast<const V*>(vals);
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
      reinterpret_cast<const void*>(fused_cg_kernel<M, V>),
      dim3(static_cast<unsigned>(grid)), dim3(kBlock), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int M, typename V>
int launch_cluster(const void* vals, const void* lcols, const void* slice_ptr,
                   const void* windows, const void* b, const void* invd,
                   const void* x0, void* x, void* stats, int ctas,
                   int max_slots, int max_win, int maxiter, float tol2,
                   void* active_out, void* stream) {
  if (ctas < 1 || ctas > kMaxCtas || max_slots < 0 || max_slots % 32 ||
      max_win < 1 || max_win > kMaxWindow ||
      cluster_smem_bytes<V>(max_slots, max_win) > kSmemBudget ||
      reinterpret_cast<uintptr_t>(vals) % 16 ||
      reinterpret_cast<uintptr_t>(lcols) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem =
      static_cast<int>(cluster_smem_bytes<V>(max_slots, max_win));
  auto kernel = fused_cg_cluster_kernel<M, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kCta);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active_out) *static_cast<int*>(active_out) = active;
  if (active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const V*>(vals),
      static_cast<const uint16_t*>(lcols),
      static_cast<const int64_t*>(slice_ptr),
      static_cast<const int32_t*>(windows), static_cast<const float*>(b),
      static_cast<const float*>(invd), static_cast<const float*>(x0),
      static_cast<float*>(x), static_cast<double*>(stats), max_slots,
      max_win, maxiter, tol2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
  return launch_grid<kFull, float>(slice_ptr, cols, vals, b, invd, x, r, p,
                                   ap, part, max_blocks, stats, n, maxiter,
                                   tol2, stream);
}

// The same solve on int8 or bfloat16 values (float vectors).
int ddps_fused_cg_i8(const void* slice_ptr, const void* cols, const void* vals,
                     const void* b, const void* invd, void* x, void* r,
                     void* p, void* ap, void* part, int64_t max_blocks,
                     void* stats, int64_t n, int maxiter, float tol2,
                     void* stream) {
  return launch_grid<kFull, int8_t>(slice_ptr, cols, vals, b, invd, x, r, p,
                                    ap, part, max_blocks, stats, n, maxiter,
                                    tol2, stream);
}
int ddps_fused_cg_bf16(const void* slice_ptr, const void* cols,
                       const void* vals, const void* b, const void* invd,
                       void* x, void* r, void* p, void* ap, void* part,
                       int64_t max_blocks, void* stats, int64_t n, int maxiter,
                       float tol2, void* stream) {
  return launch_grid<kFull, __nv_bfloat16>(slice_ptr, cols, vals, b, invd, x,
                                           r, p, ap, part, max_blocks, stats,
                                           n, maxiter, tol2, stream);
}

// A cluster of ctas CTAs (1 to 16) of 1024 rows; lcols the slots' 16-bit
// window columns, windows (lo, width) per CTA, max_slots (a multiple of 32)
// and max_win the largest CTA's slots and window.  active_out (a host int,
// or null) receives cudaOccupancyMaxActiveClusters for this launch; a
// launch with none resident returns cudaErrorInvalidConfiguration.
int ddps_fused_cg_cluster_f32(const void* vals, const void* lcols,
                              const void* slice_ptr, const void* windows,
                              const void* b, const void* invd, const void* x0,
                              void* x, void* stats, int ctas, int max_slots,
                              int max_win, int maxiter, float tol2,
                              void* active_out, void* stream) {
  return launch_cluster<kFull, float>(vals, lcols, slice_ptr, windows, b,
                                      invd, x0, x, stats, ctas, max_slots,
                                      max_win, maxiter, tol2, active_out,
                                      stream);
}

// The same solve on int8 or bfloat16 values: the slots take 3 or 4 bytes of
// shared memory instead of 6.
int ddps_fused_cg_cluster_i8(const void* vals, const void* lcols,
                             const void* slice_ptr, const void* windows,
                             const void* b, const void* invd, const void* x0,
                             void* x, void* stats, int ctas, int max_slots,
                             int max_win, int maxiter, float tol2,
                             void* active_out, void* stream) {
  return launch_cluster<kFull, int8_t>(vals, lcols, slice_ptr, windows, b,
                                       invd, x0, x, stats, ctas, max_slots,
                                       max_win, maxiter, tol2, active_out,
                                       stream);
}
int ddps_fused_cg_cluster_bf16(const void* vals, const void* lcols,
                               const void* slice_ptr, const void* windows,
                               const void* b, const void* invd,
                               const void* x0, void* x, void* stats, int ctas,
                               int max_slots, int max_win, int maxiter,
                               float tol2, void* active_out, void* stream) {
  return launch_cluster<kFull, __nv_bfloat16>(
      vals, lcols, slice_ptr, windows, b, invd, x0, x, stats, ctas, max_slots,
      max_win, maxiter, tol2, active_out, stream);
}

// Measurement entries: the same launches in mode 0 (barriers and
// reductions), 1 (and the matvec) or 2 (the solve).
int ddps_fused_cg_study_f32(int mode, const void* slice_ptr, const void* cols,
                            const void* vals, const void* b, const void* invd,
                            void* x, void* r, void* p, void* ap, void* part,
                            int64_t max_blocks, void* stats, int64_t n,
                            int maxiter, float tol2, void* stream) {
  switch (mode) {
    case kSkeleton:
      return launch_grid<kSkeleton, float>(slice_ptr, cols, vals, b, invd, x,
                                           r, p, ap, part, max_blocks, stats,
                                           n, maxiter, tol2, stream);
    case kMatvec:
      return launch_grid<kMatvec, float>(slice_ptr, cols, vals, b, invd, x, r,
                                         p, ap, part, max_blocks, stats, n,
                                         maxiter, tol2, stream);
    case kFull:
      return launch_grid<kFull, float>(slice_ptr, cols, vals, b, invd, x, r,
                                       p, ap, part, max_blocks, stats, n,
                                       maxiter, tol2, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int ddps_fused_cg_cluster_study_f32(int mode, const void* vals,
                                    const void* lcols, const void* slice_ptr,
                                    const void* windows, const void* b,
                                    const void* invd, const void* x0, void* x,
                                    void* stats, int ctas, int max_slots,
                                    int max_win, int maxiter, float tol2,
                                    void* active_out, void* stream) {
  switch (mode) {
    case kSkeleton:
      return launch_cluster<kSkeleton, float>(
          vals, lcols, slice_ptr, windows, b, invd, x0, x, stats, ctas,
          max_slots, max_win, maxiter, tol2, active_out, stream);
    case kMatvec:
      return launch_cluster<kMatvec, float>(
          vals, lcols, slice_ptr, windows, b, invd, x0, x, stats, ctas,
          max_slots, max_win, maxiter, tol2, active_out, stream);
    case kFull:
      return launch_cluster<kFull, float>(
          vals, lcols, slice_ptr, windows, b, invd, x0, x, stats, ctas,
          max_slots, max_win, maxiter, tol2, active_out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ddps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
