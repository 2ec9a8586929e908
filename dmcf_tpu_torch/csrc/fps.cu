// Farthest-point sampling for Hopper (sm_90a): the whole sequential pick
// loop of every set of a batch in one launch.
//
// Replaces no TPU kernel: the JAX package runs farthest-point sampling as
// an XLA fori_loop (dmcf_tpu/ops/sph.py:223 farthest_point_sample), the
// reference's CUDA op FarthestPointSample (utils/tools/sampling.cu:125-190)
// before it.  It builds the pyramid of the models' voxel_size: null option
// (one launch a coarse scale a step).  Contract: dmcf_tpu_torch/kernels/
// fps.py, which also chooses the schedule (``schedule``) and passes it in.
//
// What bounds it: the sample_max picks depend on each other (pick s needs
// the arg-max of the distances to picks 0..s-1), so a set is a chain of
// sample_max arg-max reductions.  Its work (n distance updates a pick,
// ~9 fp32 operations each) and its bytes are microseconds of the card; the
// latency of one pick, times sample_max, is the floor.  The design
// shortens what every pick waits on:
// - the arg-max is two redux.sync instructions a warp: each running
//   minimum maps to an order-preserving 32-bit key (``order_key``),
//   __reduce_max_sync finds the largest key and __reduce_min_sync the
//   lowest row index among the lanes that hold it;
// - each thread holds its rows' positions and running minima in registers
//   (row tid + k * threads, k < kItems), and its candidate carries its
//   position, so the next pick's centre comes by a shuffle: the pick loop
//   reads no position from shared or global memory;
// - one warp a set where a warp holds the set (``fps_warp_kernel``): no
//   block barrier at all;
// - a larger set takes a block of warps (``fps_block_kernel``) and one
//   barrier a pick: each warp's winner lane writes the warp's partial
//   (key, row, position) into one of two shared buffers by the pick's
//   parity, and every warp reduces the partials itself with the same two
//   redux instructions and shuffles the centre from the winner warp's
//   lane (known from the row: no ballot), so no second barrier hands the
//   winner out;
// - past the registers' capacity (``fps_workspace_kernel``, n > 8,192)
//   the minima live in a global workspace and the positions in dynamic
//   shared memory (opted in above 48 KB; past the opt-in limit global
//   memory), with the same arg-max and one barrier a pick.
//
// Bitwise equal to the plain version (kernels/fps.py): the distance is
// fma(dz, dz, fma(dy, dy, dx * dx)) with dx = p - cur, the fused
// multiply-adds XLA's CPU compiler makes of JAX's sum((pos - cur) ** 2),
// written with _rn intrinsics so that nvcc fuses nothing else; the
// running minimum is exact; and the arg-max takes the largest value, the
// lowest index among equal ones (torch.argmax and jnp.argmax), an order on
// (value, -index) that any reduction tree gives the same way.  Masked rows
// hold -inf, which fminf keeps, as the plain version never updates them;
// positions are finite (a NaN would be ignored here and propagated by
// torch.minimum).  Pick 0 runs the same loop with a NaN centre: fminf
// ignores the NaN distance, so the arg-max of the initial minima (+inf a
// valid row, -inf a masked one) is the lowest valid row, 0 if none, the
// plain version's argmax of the mask.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;

// The rows a thread the register kernels are built for, X(items, cap),
// each with the most threads its block may have (its launch bounds: 64
// registers a thread at 1,024 threads, 8 rows taking 32 of them; 128 at
// 512).  So the registers hold at most 8,192 rows a set.  The one table of
// these: kernels/fps.py reads it for its schedule.
#define FPS_ITEMS_TABLE(X)                                                 \
  X(1, 1024) X(2, 1024) X(3, 1024) X(4, 1024) X(6, 1024) X(8, 1024)        \
  X(12, 512) X(16, 512)

// A running minimum's order-preserving key: a valid row's minimum is >= +0
// (+inf before its first update), whose float bits order like the values;
// plus 1 leaves 0 for a masked row's -inf.
__device__ __forceinline__ unsigned order_key(float v) {
  return v >= 0.0f ? __float_as_uint(v) + 1u : 0u;
}

__device__ __forceinline__ float sq_dist(float px, float py, float pz,
                                         float cx, float cy, float cz) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// The warp's (largest key, lowest index) winner, known to every lane.
__device__ __forceinline__ unsigned warp_argmax(unsigned key, unsigned i) {
  const unsigned top = __reduce_max_sync(kFull, key);
  return __reduce_min_sync(kFull, key == top ? i : UINT_MAX);
}

// A thread's rows: row first + k * stride (k < kItems), in registers.
template <int kItems>
struct Rows {
  float x[kItems], y[kItems], z[kItems], md[kItems];

  __device__ __forceinline__ void load(const float* src,
                                       const unsigned char* m, int n,
                                       int first, int stride) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = first + k * stride;
      const bool in = j < n;
      x[k] = in ? src[3 * j] : 0.0f;
      y[k] = in ? src[3 * j + 1] : 0.0f;
      z[k] = in ? src[3 * j + 2] : 0.0f;
      md[k] = in && m[j] != 0 ? INFINITY : -INFINITY;  // rows past n: -inf
    }
  }

  // Updates the minima by the centre c and returns the thread's candidate:
  // its largest minimum (the lowest slot among equal ones: the slots run
  // in row order) by a tree over the slots, its slot and that row's
  // position (selected after the tree, off the path to the warp's
  // reduction).
  __device__ __forceinline__ int update(float cx, float cy, float cz,
                                       float& bv, float& bx, float& by,
                                       float& bz) {
    float v[kItems];
    int slot[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      md[k] = fminf(md[k], sq_dist(x[k], y[k], z[k], cx, cy, cz));
      v[k] = md[k];
      slot[k] = k;
    }
#pragma unroll
    for (int w = 1; w < kItems; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < kItems; k += 2 * w) {
        if (v[k + w] > v[k]) {  // the higher slots win only when larger
          v[k] = v[k + w];
          slot[k] = slot[k + w];
        }
      }
    }
    bv = v[0];
    bx = x[0];
    by = y[0];
    bz = z[0];
#pragma unroll
    for (int k = 1; k < kItems; ++k) {
      if (slot[0] == k) {
        bx = x[k];
        by = y[k];
        bz = z[k];
      }
    }
    return slot[0];
  }
};

__device__ __forceinline__ void write_sel(unsigned char* sel, int cnt,
                                          int sample_max, int first,
                                          int stride) {
  for (int j = first; j < sample_max; j += stride) sel[j] = j < cnt ? 1 : 0;
}

// The warps' partials: each warp's winner (key, row) and its position, in
// two buffers by the pick's parity (see the file note); the slots past
// the block's warps hold (0, UINT_MAX), which never wins.
struct Partials {
  uint2 key_row[2][kMaxWarps];
  float4 pos[2][kMaxWarps];

  __device__ __forceinline__ void clear() {  // then a barrier
    for (int t = threadIdx.x; t < 2 * kMaxWarps; t += blockDim.x) {
      key_row[t / kMaxWarps][t % kMaxWarps] = make_uint2(0u, UINT_MAX);
      pos[t / kMaxWarps][t % kMaxWarps] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
};

// The block's winner among its threads' candidates (key, row i, position),
// known to every thread with its position (the next pick's centre), after
// one barrier.  Thread t's rows are t + k * blockDim.x and blockDim.x is a
// power of two, so row i lies in lane i & 31 of warp (i & (blockDim.x -
// 1)) >> 5: each warp's winner lane writes the warp's partial, and every
// warp reduces the partials and shuffles the position from the winner
// warp's slot.
__device__ __forceinline__ unsigned block_argmax(unsigned key, unsigned i,
                                                 float x, float y, float z,
                                                 int parity, Partials& red,
                                                 float& cx, float& cy,
                                                 float& cz) {
  const int lane = threadIdx.x & 31;
  const unsigned wi = warp_argmax(key, i);
  if (lane == static_cast<int>(wi & 31u)) {
    red.key_row[parity][threadIdx.x >> 5] = make_uint2(key, wi);
    red.pos[parity][threadIdx.x >> 5] = make_float4(x, y, z, 0.f);
  }
  __syncthreads();
  const uint2 kr = red.key_row[parity][lane];
  const float4 p = red.pos[parity][lane];
  const unsigned win = warp_argmax(kr.x, kr.y);
  const int from = static_cast<int>(win & (blockDim.x - 1)) >> 5;
  cx = __shfl_sync(kFull, p.x, from);
  cy = __shfl_sync(kFull, p.y, from);
  cz = __shfl_sync(kFull, p.z, from);
  return win;
}

// One warp a set (a block of 32 threads): lane l holds rows l + 32 k; no
// block barrier.
template <int kItems>
__global__ void __launch_bounds__(32)
    fps_warp_kernel(const float* __restrict__ pos,
                    const unsigned char* __restrict__ mask,
                    const int* __restrict__ count, int n, int sample_max,
                    int* __restrict__ idx, unsigned char* __restrict__ sel) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  write_sel(sel + static_cast<size_t>(b) * sample_max, count[b], sample_max,
            lane, 32);
  Rows<kItems> r;
  r.load(pos + static_cast<size_t>(b) * n * 3,
         mask + static_cast<size_t>(b) * n, n, lane, 32);
  int* out = idx + static_cast<size_t>(b) * sample_max;
  float cx = NAN, cy = NAN, cz = NAN;  // pick 0 updates nothing
  for (int s = 0; s < sample_max; ++s) {
    float bv, bx, by, bz;
    const int bk = r.update(cx, cy, cz, bv, bx, by, bz);
    const unsigned win = warp_argmax(order_key(bv), lane + 32 * bk);
    const int owner = static_cast<int>(win & 31u);
    cx = __shfl_sync(kFull, bx, owner);
    cy = __shfl_sync(kFull, by, owner);
    cz = __shfl_sync(kFull, bz, owner);
    if (lane == 0) out[s] = static_cast<int>(win);
  }
}

// A block a set: thread t holds rows t + k * blockDim.x (at most kCap
// threads); one barrier a pick.
template <int kItems, int kCap>
__global__ void __launch_bounds__(kCap)
    fps_block_kernel(const float* __restrict__ pos,
                     const unsigned char* __restrict__ mask,
                     const int* __restrict__ count, int n, int sample_max,
                     int* __restrict__ idx, unsigned char* __restrict__ sel) {
  __shared__ Partials red;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  write_sel(sel + static_cast<size_t>(b) * sample_max, count[b], sample_max,
            tid, bd);
  Rows<kItems> r;
  r.load(pos + static_cast<size_t>(b) * n * 3,
         mask + static_cast<size_t>(b) * n, n, tid, bd);
  red.clear();
  __syncthreads();
  int* out = idx + static_cast<size_t>(b) * sample_max;
  float cx = NAN, cy = NAN, cz = NAN;  // pick 0 updates nothing
  for (int s = 0; s < sample_max; ++s) {
    float bv, bx, by, bz;
    const int bk = r.update(cx, cy, cz, bv, bx, by, bz);
    const unsigned win =
        block_argmax(order_key(bv), static_cast<unsigned>(tid + bd * bk), bx,
                     by, bz, s & 1, red, cx, cy, cz);
    if (tid == 0) out[s] = static_cast<int>(win);
  }
}

// Past the registers: the minima in ``work`` [batch, n], the positions in
// dynamic shared memory (kShared) or read from global memory.
template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
    fps_workspace_kernel(const float* __restrict__ pos,
                         const unsigned char* __restrict__ mask,
                         const int* __restrict__ count, int n,
                         int sample_max, int* __restrict__ idx,
                         unsigned char* __restrict__ sel,
                         float* __restrict__ work) {
  extern __shared__ float staged[];
  __shared__ Partials red;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const float* src = pos + static_cast<size_t>(b) * n * 3;
  const unsigned char* m = mask + static_cast<size_t>(b) * n;
  const float* P = src;
  if constexpr (kShared) {
    for (int j = tid; j < 3 * n; j += bd) staged[j] = src[j];
    P = staged;
  }
  write_sel(sel + static_cast<size_t>(b) * sample_max, count[b], sample_max,
            tid, bd);
  float* wk = work + static_cast<size_t>(b) * n;
  for (int j = tid; j < n; j += bd) wk[j] = m[j] != 0 ? INFINITY : -INFINITY;
  red.clear();
  __syncthreads();  // the staged positions and the cleared partials
  int* out = idx + static_cast<size_t>(b) * sample_max;
  float cx = NAN, cy = NAN, cz = NAN;  // pick 0 updates nothing
  for (int s = 0; s < sample_max; ++s) {
    float bv = -INFINITY, bx = 0.0f, by = 0.0f, bz = 0.0f;
    unsigned bi = UINT_MAX;  // a thread without a row: key 0, never wins
    for (int j = tid; j < n; j += bd) {
      const float px = P[3 * j], py = P[3 * j + 1], pz = P[3 * j + 2];
      const float d = fminf(wk[j], sq_dist(px, py, pz, cx, cy, cz));
      wk[j] = d;
      if (j == tid || d > bv) {
        bv = d;
        bi = static_cast<unsigned>(j);
        bx = px;
        by = py;
        bz = pz;
      }
    }
    const unsigned win = block_argmax(order_key(bv), bi, bx, by, bz, s & 1,
                                      red, cx, cy, cz);
    if (tid == 0) out[s] = static_cast<int>(win);
  }
}

template <int kItems, int kCap>
int launch_registers(int regime, int warps, int batch,
                     cudaStream_t st, const float* pos,
                     const unsigned char* mask, const int* count, int n,
                     int sample_max, int* idx, unsigned char* sel) {
  const int threads = 32 * warps;
  if (regime == 0) {
    if (warps != 1 || 32 * kItems < n)
      return static_cast<int>(cudaErrorInvalidValue);
    fps_warp_kernel<kItems><<<batch, 32, 0, st>>>(pos, mask, count, n,
                                                  sample_max, idx, sel);
  } else {
    if (threads > kCap || threads * kItems < n)
      return static_cast<int>(cudaErrorInvalidValue);
    fps_block_kernel<kItems, kCap><<<batch, threads, 0, st>>>(
        pos, mask, count, n, sample_max, idx, sel);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kShared>
int launch_workspace(int batch, int threads, size_t smem, cudaStream_t st,
                     const float* pos, const unsigned char* mask,
                     const int* count, int n, int sample_max, int* idx,
                     unsigned char* sel, float* work) {
  auto kernel = fps_workspace_kernel<kShared>;
  if (kShared) {
    // per device: set on every launch, as the K-list kernels do
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<batch, threads, kShared ? smem : 0, st>>>(
      pos, mask, count, n, sample_max, idx, sel, work);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos [batch, n, 3] fp32, mask [batch, n] bool, count [batch] int32 ->
// idx [batch, sample_max] int32, sel [batch, sample_max] bool (j < count),
// by the schedule kernels/fps.py chooses:
//   regime 0: one warp a set (``warps`` 1), ``items`` rows a lane
//             (32 * items >= n);
//   regime 1: a block of ``warps`` warps a set (a power of two), ``items``
//             rows a thread (32 * warps * items >= n, 32 * warps at most
//             the items' cap in FPS_ITEMS_TABLE);
//   regime 2: a block of ``warps`` warps a set (a power of two), the minima
//             in ``work`` (n floats a set).
// ``items`` is one of FPS_ITEMS_TABLE's.  Returns a CUDA
// error code (cudaErrorInvalidValue for a schedule outside these).
extern "C" int fps_launch(const float* pos, const unsigned char* mask,
                          const int* count, int batch, int n, int sample_max,
                          int regime, int warps, int items,
                          int* idx, unsigned char* sel, float* work,
                          void* stream) {
  if (batch <= 0) return 0;
  const bool pow2 = warps > 0 && (warps & (warps - 1)) == 0;
  if (n < 1 || sample_max < 1 || warps < 1 || warps > kMaxWarps ||
      (regime != 0 && !pow2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (regime == 2) {
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int device = 0, optin = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    const size_t smem = static_cast<size_t>(n) * 3 * sizeof(float);
    // the static partials share the block's shared memory
    const bool shared = smem + sizeof(Partials) <= static_cast<size_t>(optin);
    return shared ? launch_workspace<true>(batch, 32 * warps, smem, st, pos,
                                           mask, count, n, sample_max, idx,
                                           sel, work)
                  : launch_workspace<false>(batch, 32 * warps, 0, st, pos,
                                            mask, count, n, sample_max, idx,
                                            sel, work);
  }
  if (regime != 0 && regime != 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define FPS_ITEMS_CASE(K, CAP)                                              \
  case K:                                                                   \
    return launch_registers<K, CAP>(regime, warps, batch, st, pos, mask,    \
                                    count, n, sample_max, idx, sel);
  switch (items) {
    FPS_ITEMS_TABLE(FPS_ITEMS_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FPS_ITEMS_CASE
}
