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
// yp*2 + xp].  A group's taps are summed before its multiply, as JAX does.
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
// 4 B x 1,384,448 slots = 11.6 MB (3.46 us at 3.35 TB/s); the whole working
// set fits in the 50 MB L2, so at that size latency and instruction issue,
// not DRAM, decide the time.
//
// Design.  A block owns a tile of 4 rows x 128 lanes (one warp per row, each
// lane computing lanes t, t+32, t+64, t+96 of it, so every shared-memory read
// of a warp is 32 consecutive words and every store 32 consecutive slots) and
// marches zc layers of z.  The x-planes it needs (the tile with a one-row,
// one-lane halo) live in a ring of four planes in shared memory, filled by
// cp.async in 16-byte vectors (row and column of a vector from shifts and
// masks; rows and halos outside the space are zero-filled by the copy): while
// layer z is computed from planes z-1, z, z+1, plane z+2 is in flight, and a
// layer costs one barrier; a layer's correction loads go out before its taps.
// The taps are a loop unrolled at compile time over the slots in group
// order, each slot's neighbour offset and plane from the parameter block
// (constant bank).  The two groupings the package builds (TETRA4 boxes:
// groups of 12, 6 and 1 taps; HEX8: 26 and 1) are template instances whose
// group ends are compile-time, so the loop is straight-line code and later
// taps' loads issue while earlier sums complete; any other pattern of at
// most 27 taps runs the same loop with its group ends read from the
// parameter block.  zc is the shallowest march whose grid fits in one wave
// of resident blocks (4 at the 1M box, 8 on a 10M-DOF space of mxp = 256).
// 8-row tiles were timed and lost at both sizes (PERF.md, Findings).  A design with one output per thread, tap bounds read at run
// time and load and compute chained by two barriers per layer was bound by
// its tap loop, not its loads.  This one takes 9.0 us in f32 at the 1M box
// (10.7 us with L2 flushed; bound 3.46 us), 14.2 us with f64 vectors (16.5
// us flushed; bound 6.32 us), and 60.0 us on a 10M-DOF space (bound 33.3
// us), each device time per call from torch.profiler (NVIDIA H100 80GB
// HBM3, 700.00 W; chip_smoke.py phase E).
//
// Contract.  T (float or double) is the type of x, y and the accumulator;
// C (bfloat16 bits as uint16, or float) the storage of corr; coefficients are
// float and upcast to T.  myp must be a multiple of 8 and mxp of 128 (the
// operator's geometry guarantees both), x 16-byte aligned.  The launch
// allocates nothing, runs on the caller's stream and does not synchronise;
// each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTX = 128;  // lanes per tile
constexpr int kTY = 4;    // rows per tile, one warp each
constexpr int kThreads = 32 * kTY;
constexpr int kVec = 4;   // lanes per thread, 32 apart
constexpr int kRing = 4;  // x-planes in shared memory
constexpr int kMaxTaps = 27;
constexpr int kMaxGroups = 27;

struct StencilParams {
  int n_taps;
  int n_groups;
  int off[kMaxTaps];   // dy * row stride + dx, in group order
  int dz[kMaxTaps];    // -1, 0, 1
  int gid[kMaxTaps];   // group of the slot
  int gend[kMaxTaps];  // 1 if the slot is its group's last
  float quads[kMaxGroups * 8];
  int mx, my, mz, myp, mxp, Z, zc;
};

// Row geometry of a plane in shared memory, per element type: the 128 lanes
// start 16 bytes in (so every vector lands aligned), the left halo lane just
// before them, the right one just after.
template <typename T>
struct Plane {
  static constexpr int kOff = 16 / sizeof(T);
  static constexpr int kStride = kTX + 2 * kOff;
  static constexpr int kVecs = kTX * sizeof(T) / 16;  // 16-byte vectors per row
};

// The grouping of the taps, in slot order, when it is known at compile time:
// GroupSizes<12, 6, 1> is every TETRA4 box the package builds (19 taps),
// GroupSizes<26, 1> every HEX8 box (27 taps).  GroupSizes<> reads the
// grouping from the parameter block (any pattern of at most 27 taps).
template <int... G>
struct GroupSizes {
  static constexpr int kGroups = sizeof...(G);
  static constexpr int kSlots = (0 + ... + G);
};
using Tetra4Groups = GroupSizes<12, 6, 1>;
using Hex8Groups = GroupSizes<26, 1>;

// Group and group end of every slot of GroupSizes<G...> (G non-empty).
template <int... G>
struct SlotTable {
  static constexpr int kSlots = (0 + ... + G);
  int gid[kSlots];
  bool end[kSlots];
  __host__ __device__ constexpr SlotTable() : gid{}, end{} {
    const int sizes[] = {G...};
    int s = 0;
    for (int g = 0; g < static_cast<int>(sizeof...(G)); ++g) {
      for (int i = 0; i < sizes[g]; ++i, ++s) {
        gid[s] = g;
        end[s] = i + 1 == sizes[g];
      }
    }
  }
};

__device__ __forceinline__ float load_corr(const uint16_t* p, int64_t k) {
  return __uint_as_float(static_cast<unsigned>(__ldg(p + k)) << 16);
}
__device__ __forceinline__ float load_corr(const float* p, int64_t k) {
  return __ldg(p + k);
}

// cp.async of `bytes` (4, 8 or 16) from global to shared; zero-filled when
// !valid (src then only has to be a valid address).
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(n)
                 : "memory");
  }
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of x-plane z (rows r0-1 .. r0+4, lanes l0-1 .. l0+128)
// into buf.  Anything outside the padded space reads 0 (it only feeds pads).
template <typename T>
__device__ __forceinline__ void load_plane(T* buf, const T* __restrict__ x,
                                           int z, int r0, int l0, int Z,
                                           int myp, int mxp, int tid) {
  using P = Plane<T>;
  constexpr int kRows = kTY + 2;
  constexpr int kEl = 16 / sizeof(T);
  const bool z_ok = z >= 0 && z < Z;
  const int64_t plane0 = static_cast<int64_t>(z) * myp;
  for (int v = tid; v < kRows * P::kVecs; v += kThreads) {
    const int rr = v / P::kVecs;  // compile-time power of two: a shift
    const int cc = v % P::kVecs;
    const int gr = r0 - 1 + rr;
    const bool ok = z_ok && gr >= 0 && gr < myp;
    const T* src = ok ? x + (plane0 + gr) * mxp + l0 + cc * kEl : x;
    copy_async<16>(buf + rr * P::kStride + P::kOff + cc * kEl, src, ok);
  }
  if (tid < 2 * kRows) {
    const int rr = tid >> 1;
    const int right = tid & 1;
    const int gr = r0 - 1 + rr;
    const int gl = right ? l0 + kTX : l0 - 1;
    const bool ok = z_ok && gr >= 0 && gr < myp && gl >= 0 && gl < mxp;
    const T* src = ok ? x + (plane0 + gr) * mxp + gl : x;
    copy_async<sizeof(T)>(
        buf + rr * P::kStride + (right ? P::kOff + kTX : P::kOff - 1), src, ok);
  }
}

// acc[k] = sum over groups g of q_g * (sum of the x of g's taps) at lane
// in_plane + 32k of layer z, the taps in slot order.  Grouping read from
// the parameter block: each slot's group end is a uniform branch.
template <typename T, int kPlane>
__device__ __forceinline__ void tap_sums(const T* ring, int z, int in_plane,
                                         const T* coef, int pidx,
                                         const StencilParams& p,
                                         T (&acc)[kVec], GroupSizes<>) {
  T w[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = w[k] = T(0);
#pragma unroll
  for (int s = 0; s < kMaxTaps; ++s) {
    if (s < p.n_taps) {
      const T* src = ring + ((z + p.dz[s]) & 3) * kPlane + in_plane + p.off[s];
#pragma unroll
      for (int k = 0; k < kVec; ++k) w[k] += src[32 * k];
      if (p.gend[s]) {
        const T c = coef[p.gid[s] * 8 + pidx];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          acc[k] += c * w[k];
          w[k] = T(0);
        }
      }
    }
  }
}

// The same with the grouping known at compile time: straight-line code,
// so the loads of later taps issue while earlier sums complete.
template <typename T, int kPlane, int... G>
__device__ __forceinline__ void tap_sums(const T* ring, int z, int in_plane,
                                         const T* coef, int pidx,
                                         const StencilParams& p,
                                         T (&acc)[kVec], GroupSizes<G...>) {
  constexpr SlotTable<G...> kTable{};
  T w[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = w[k] = T(0);
#pragma unroll
  for (int s = 0; s < kTable.kSlots; ++s) {
    const T* src = ring + ((z + p.dz[s]) & 3) * kPlane + in_plane + p.off[s];
#pragma unroll
    for (int k = 0; k < kVec; ++k) w[k] += src[32 * k];
    if (kTable.end[s]) {
      const T c = coef[kTable.gid[s] * 8 + pidx];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        acc[k] += c * w[k];
        w[k] = T(0);
      }
    }
  }
}

template <typename T, typename C, typename Groups>
__global__ void __launch_bounds__(kThreads)
pad_stencil_kernel(const T* __restrict__ x, const C* __restrict__ corr,
                   T* __restrict__ y, const __grid_constant__ StencilParams p) {
  using P = Plane<T>;
  constexpr int kPlane = (kTY + 2) * P::kStride;  // elements per ring plane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* coef = ring + kRing * kPlane;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wrow = tid >> 5;  // the warp's row in the tile
  const int l0 = blockIdx.x * kTX, r0 = blockIdx.y * kTY;
  const int Z = p.Z, myp = p.myp, mxp = p.mxp;
  const int z0 = blockIdx.z * p.zc;
  const int z1 = min(z0 + p.zc, Z);
  const int r = r0 + wrow;

  load_plane<T>(ring + ((z0 - 1) & 3) * kPlane, x, z0 - 1, r0, l0, Z, myp,
                mxp, tid);
  load_plane<T>(ring + (z0 & 3) * kPlane, x, z0, r0, l0, Z, myp, mxp, tid);
  load_plane<T>(ring + ((z0 + 1) & 3) * kPlane, x, z0 + 1, r0, l0, Z, myp,
                mxp, tid);
  copy_commit();
  for (int k = tid; k < p.n_groups * 8; k += kThreads) {
    coef[k] = static_cast<T>(p.quads[k]);
  }

  const bool row_live = r >= 1 && r <= p.my;
  const int yx_parity = (((r - 1) & 1) << 1) | (lane & 1);  // l0, 32k even
  const int in_plane = (wrow + 1) * P::kStride + P::kOff + lane;
  for (int z = z0; z < z1; ++z) {
    copy_wait_all();  // plane z+1, this thread's copies
    __syncthreads();  // everyone's copies landed; layer z-1 read its planes
    if (z + 2 <= z1) {
      load_plane<T>(ring + ((z + 2) & 3) * kPlane, x, z + 2, r0, l0, Z, myp,
                    mxp, tid);
      copy_commit();
    }
    T out[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) out[k] = T(0);
    const int64_t row_slot =
        (static_cast<int64_t>(z) * myp + r) * mxp + l0 + lane;
    if (row_live && z >= 1 && z <= p.mz) {  // uniform across the warp
      // The correction's loads go out first, so the taps hide their
      // latency.
      float cv[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        cv[k] = l0 + lane + 32 * k < p.mx ? load_corr(corr, row_slot + 32 * k)
                                          : 0.0f;
      }
      const int pidx = (((z - 1) & 1) << 2) | yx_parity;
      T acc[kVec];
      tap_sums<T, kPlane>(ring, z, in_plane, coef, pidx, p, acc, Groups{});
      const T* mid = ring + (z & 3) * kPlane + in_plane;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (l0 + lane + 32 * k < p.mx) {
          out[k] = acc[k] + static_cast<T>(cv[k]) * mid[32 * k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) y[row_slot + 32 * k] = out[k];
  }
}

// Blocks of this instance resident on the whole card at once (one wave),
// from the occupancy calculator (per SM, asked once per instance); 0 if it
// cannot tell.
template <typename T, typename C, typename Groups>
int resident_blocks(size_t smem) {
  static const int per_sm = [smem] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, pad_stencil_kernel<T, C, Groups>, kThreads, smem) !=
        cudaSuccess) {
      cudaGetLastError();  // a failed query is not the launch's error
      return 0;
    }
    return n;
  }();
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * per_sm;
}

// dxy: host (dx, dy) of every slot; the offsets take this instance's row
// stride.
template <typename T, typename C, typename Groups>
int launch_groups(const T* x, const C* corr, T* y, StencilParams p,
                  const int* dxy, int zc, cudaStream_t stream) {
  using P = Plane<T>;
  for (int s = 0; s < p.n_taps; ++s) {
    p.off[s] = dxy[2 * s + 1] * P::kStride + dxy[2 * s];
  }
  const size_t smem =
      (kRing * (kTY + 2) * P::kStride + kMaxGroups * 8) * sizeof(T);
  if (zc <= 0) {
    // The shallowest march (from 2 layers) whose grid fits in one wave of
    // resident blocks: the z-halo (2 planes per march) is re-read least
    // where no block waits for a second wave.  A grid too large for one
    // wave at 16 layers marches 8.
    const int tiles = (p.mxp / kTX) * (p.myp / kTY);
    const int wave = resident_blocks<T, C, Groups>(smem);
    zc = 8;
    for (int d = 2; d <= 16; d *= 2) {
      if (tiles * ((p.Z + d - 1) / d) <= wave) {
        zc = d;
        break;
      }
    }
  }
  p.zc = zc;
  const dim3 grid(p.mxp / kTX, p.myp / kTY, (p.Z + zc - 1) / zc);
  pad_stencil_kernel<T, C, Groups><<<grid, kThreads, smem, stream>>>(x, corr, y,
                                                                     p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename C>
int launch(const void* x, const void* corr, void* y, const int32_t* taps,
           int n_taps, const int32_t* group_start, int n_groups,
           const float* quads, int mx, int my, int mz, int myp, int mxp, int Z,
           int zc, void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || n_groups < 1 ||
      n_groups > kMaxGroups || group_start[0] != 0 ||
      group_start[n_groups] != n_taps || myp % 8 || mxp % kTX || Z < 1 ||
      zc < 0 || reinterpret_cast<uintptr_t>(x) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StencilParams p = {};
  int dxy[2 * kMaxTaps];
  p.n_taps = n_taps;
  p.n_groups = n_groups;
  for (int g = 0; g < n_groups; ++g) {
    if (group_start[g + 1] <= group_start[g]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int s = group_start[g]; s < group_start[g + 1]; ++s) {
      const int dx = taps[3 * s], dy = taps[3 * s + 1], dz = taps[3 * s + 2];
      if (dx < -1 || dx > 1 || dy < -1 || dy > 1 || dz < -1 || dz > 1) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      dxy[2 * s] = dx;
      dxy[2 * s + 1] = dy;
      p.dz[s] = dz;
      p.gid[s] = g;
      p.gend[s] = s + 1 == group_start[g + 1];
    }
  }
  for (int k = 0; k < n_groups * 8; ++k) p.quads[k] = quads[k];
  p.mx = mx;
  p.my = my;
  p.mz = mz;
  p.myp = myp;
  p.mxp = mxp;
  p.Z = Z;
  const T* xt = static_cast<const T*>(x);
  const C* ct = static_cast<const C*>(corr);
  T* yt = static_cast<T*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = group_start;
  const bool tetra4 = n_groups == 3 && gs[1] == 12 && gs[2] == 18 && gs[3] == 19;
  const bool hex8 = n_groups == 2 && gs[1] == 26 && gs[2] == 27;
  if (tetra4) return launch_groups<T, C, Tetra4Groups>(xt, ct, yt, p, dxy, zc, st);
  if (hex8) return launch_groups<T, C, Hex8Groups>(xt, ct, yt, p, dxy, zc, st);
  return launch_groups<T, C, GroupSizes<>>(xt, ct, yt, p, dxy, zc, st);
}

}  // namespace

extern "C" {

// taps: host int32 (n_taps, 3) as (dx, dy, dz), in group order;
// group_start: host int32 (n_groups + 1); quads: host float (n_groups, 8);
// zc: z-layers per block (0: chosen from the grid and the occupancy).
#define DDPS_PAD_ENTRY(NAME, T, C)                                            \
  int NAME(const void* x, const void* corr, void* y, const int32_t* taps,    \
           int n_taps, const int32_t* group_start, int n_groups,             \
           const float* quads, int mx, int my, int mz, int myp, int mxp,     \
           int Z, int zc, void* stream) {                                    \
    return launch<T, C>(x, corr, y, taps, n_taps, group_start, n_groups,     \
                        quads, mx, my, mz, myp, mxp, Z, zc, stream);         \
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
