// Lattice-stencil SpMV over a padded 3-D vector space for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// domain_decomposed_pde_solver_tpu/ops/pallas/stencil_kernel.py::_kernel
// (launched by pad_stencil_spmv through _pad_stencil_call).  Vectors live in
// the operator's padded space (Z, myp, mxp), flattened z-major; a real node
// (iz, iy, ix) sits at z = iz + 1, row r = iy + 1, lane l = ix.  The kernel
// computes, for every slot,
//
//     y[z, r, l] = sum_g q_g(parity) * sum_{taps t of g} x[z+dz_t, r+dy_t, l+dx_t]
//                  + corr[z, r, l] * x[z, r, l]
//
// on real nodes and writes 0 on every pad slot (the pad-slot invariant the
// solvers rely on).  The parity is that of the node's grid coordinates,
// (iz & 1, iy & 1, ix & 1), not of its padded ones: q_g = quads[g][zp*4 +
// yp*2 + xp].  A group's windows are summed before its multiply, as JAX does.
// Neighbours across the grid's edge are pad slots, which hold 0 in x.
//
// The TPU kernel's roll factoring and DMA ring exist because of VMEM and
// lane rolls; they are not carried over.
//
// Bound.  On this card the product is bound by bytes: per real node it must
// read x (4 or 8 B) and corr (2 B in bfloat16, 4 B in float), and per slot
// write y (pads included), against about 2 flops per tap (19 taps on TETRA4,
// 27 on HEX8): under 4 flops per byte, far below the H100's ridge point.  At
// the 1M-DOF box the compulsory bytes in f32 are 6 B x 1,009,899 nodes +
// 4 B x 1,384,448 slots = 11.6 MB (3.46 us at 3.35 TB/s).
// The design's answer is to read x from device memory about once: a block
// owns a (kTY x kTX) tile of rows and lanes and marches through kZC layers of
// z, keeping the three x-planes it needs (with a one-row, one-lane halo) in a
// ring in shared memory, so each x value is loaded into shared memory by
// about (kZC+2)/kZC x (1 + halo) blocks, and every tap reads shared memory.
// Taps, group bounds and the (n_groups, 8) coefficient table travel in the
// kernel's parameter block (constant bank); the table is staged in shared
// memory so that lanes of different parity read it without serialising.
//
// Contract.  T (float or double) is the type of x, y and the accumulator;
// C (bfloat16 bits as uint16, or float) the storage of corr; coefficients are
// float and upcast to T.  myp must be a multiple of kTY and mxp of kTX (the
// operator's geometry guarantees multiples of 8 and 128).  The launch
// allocates nothing, runs on the caller's stream and does not synchronise;
// each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTX = 32;  // lanes per tile (one warp per row)
constexpr int kTY = 8;   // rows per tile
constexpr int kZC = 8;   // z-layers marched by one block
constexpr int kMaxTaps = 27;
constexpr int kMaxGroups = 27;

struct StencilParams {
  int n_taps;
  int n_groups;
  int group_start[kMaxGroups + 1];
  signed char dx[kMaxTaps], dy[kMaxTaps], dz[kMaxTaps];
  float quads[kMaxGroups * 8];
  int mx, my, mz, myp, mxp, Z;
};

__device__ __forceinline__ float load_corr(const uint16_t* p, int64_t k) {
  return __uint_as_float(static_cast<unsigned>(__ldg(p + k)) << 16);
}
__device__ __forceinline__ float load_corr(const float* p, int64_t k) {
  return __ldg(p + k);
}

// Stage x-plane z (rows r0-1 .. r0+kTY, lanes l0-1 .. l0+kTX) into buf;
// anything outside the padded space reads 0 (it only ever feeds pads).
template <typename T>
__device__ __forceinline__ void load_plane(T (*buf)[kTX + 2],
                                           const T* __restrict__ x, int z,
                                           int r0, int l0, int Z, int myp,
                                           int mxp, int tid) {
  const int64_t plane_slots = static_cast<int64_t>(myp) * mxp;
  for (int k = tid; k < (kTY + 2) * (kTX + 2); k += kTX * kTY) {
    const int rr = k / (kTX + 2), ll = k % (kTX + 2);
    const int gr = r0 - 1 + rr, gl = l0 - 1 + ll;
    T v = T(0);
    if (z >= 0 && z < Z && gr >= 0 && gr < myp && gl >= 0 && gl < mxp) {
      v = __ldg(x + z * plane_slots + static_cast<int64_t>(gr) * mxp + gl);
    }
    buf[rr][ll] = v;
  }
}

template <typename T, typename C>
__global__ void __launch_bounds__(kTX * kTY)
pad_stencil_kernel(const T* __restrict__ x, const C* __restrict__ corr,
                   T* __restrict__ y, const __grid_constant__ StencilParams p) {
  __shared__ T plane[3][kTY + 2][kTX + 2];
  __shared__ T coef[kMaxGroups * 8];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int l0 = blockIdx.x * kTX, r0 = blockIdx.y * kTY;
  const int Z = p.Z, myp = p.myp, mxp = p.mxp;
  const int z0 = blockIdx.z * kZC;
  const int z1 = min(z0 + kZC, Z);
  const int l = l0 + tx, r = r0 + ty;
  const int64_t plane_slots = static_cast<int64_t>(myp) * mxp;
  const int n_groups = p.n_groups;

  for (int k = tid; k < n_groups * 8; k += kTX * kTY) {
    coef[k] = static_cast<T>(p.quads[k]);
  }
  int b_lo = 0, b_mid = 1, b_hi = 2;
  load_plane(plane[b_lo], x, z0 - 1, r0, l0, Z, myp, mxp, tid);
  load_plane(plane[b_mid], x, z0, r0, l0, Z, myp, mxp, tid);
  const bool in_row = r >= 1 && r <= p.my && l < p.mx;
  const int yx_parity = (((r - 1) & 1) << 1) | (l & 1);
  for (int z = z0; z < z1; ++z) {
    load_plane(plane[b_hi], x, z + 1, r0, l0, Z, myp, mxp, tid);
    __syncthreads();
    T out = T(0);
    const int64_t idx = z * plane_slots + static_cast<int64_t>(r) * mxp + l;
    if (in_row && z >= 1 && z <= p.mz) {
      const int pidx = (((z - 1) & 1) << 2) | yx_parity;
      T acc = T(0);
      for (int g = 0; g < n_groups; ++g) {
        T w = T(0);
        for (int t = p.group_start[g]; t < p.group_start[g + 1]; ++t) {
          const int dz = p.dz[t];
          const int buf = dz < 0 ? b_lo : (dz > 0 ? b_hi : b_mid);
          w += plane[buf][ty + 1 + p.dy[t]][tx + 1 + p.dx[t]];
        }
        acc += coef[g * 8 + pidx] * w;
      }
      acc += static_cast<T>(load_corr(corr, idx)) * plane[b_mid][ty + 1][tx + 1];
      out = acc;
    }
    y[idx] = out;
    __syncthreads();  // plane b_lo is overwritten by the next load
    const int b = b_lo;
    b_lo = b_mid;
    b_mid = b_hi;
    b_hi = b;
  }
}

template <typename T, typename C>
int launch(const void* x, const void* corr, void* y, const int32_t* taps,
           int n_taps, const int32_t* group_start, int n_groups,
           const float* quads, int mx, int my, int mz, int myp, int mxp, int Z,
           void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || n_groups < 1 ||
      n_groups > kMaxGroups || myp % kTY || mxp % kTX || Z < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StencilParams p;
  p.n_taps = n_taps;
  p.n_groups = n_groups;
  for (int g = 0; g <= n_groups; ++g) p.group_start[g] = group_start[g];
  for (int t = 0; t < n_taps; ++t) {
    p.dx[t] = static_cast<signed char>(taps[3 * t]);
    p.dy[t] = static_cast<signed char>(taps[3 * t + 1]);
    p.dz[t] = static_cast<signed char>(taps[3 * t + 2]);
  }
  for (int k = 0; k < n_groups * 8; ++k) p.quads[k] = quads[k];
  p.mx = mx;
  p.my = my;
  p.mz = mz;
  p.myp = myp;
  p.mxp = mxp;
  p.Z = Z;
  const dim3 block(kTX, kTY);
  const dim3 grid(mxp / kTX, myp / kTY, (Z + kZC - 1) / kZC);
  pad_stencil_kernel<T, C><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const C*>(corr),
      static_cast<T*>(y), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// taps: host int32 (n_taps, 3) as (dx, dy, dz), in group order;
// group_start: host int32 (n_groups + 1); quads: host float (n_groups, 8).
#define DDPS_PAD_ENTRY(NAME, T, C)                                            \
  int NAME(const void* x, const void* corr, void* y, const int32_t* taps,    \
           int n_taps, const int32_t* group_start, int n_groups,             \
           const float* quads, int mx, int my, int mz, int myp, int mxp,     \
           int Z, void* stream) {                                            \
    return launch<T, C>(x, corr, y, taps, n_taps, group_start, n_groups,     \
                        quads, mx, my, mz, myp, mxp, Z, stream);             \
  }

DDPS_PAD_ENTRY(ddps_pad_stencil_f32_bf16, float, uint16_t)
DDPS_PAD_ENTRY(ddps_pad_stencil_f32_f32, float, float)
DDPS_PAD_ENTRY(ddps_pad_stencil_f64_bf16, double, uint16_t)
DDPS_PAD_ENTRY(ddps_pad_stencil_f64_f32, double, float)

#undef DDPS_PAD_ENTRY

const char* ddps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
