// Farthest-point sampling for Hopper (sm_90a): one block a point set, the
// whole sequential pick loop in one launch.
//
// Replaces no TPU kernel: the JAX package runs farthest-point sampling as
// an XLA fori_loop (dmcf_tpu/ops/sph.py:223 farthest_point_sample), the
// reference's CUDA op FarthestPointSample (utils/tools/sampling.cu:125-190)
// before it.  It builds the pyramid of the models' voxel_size: null option
// (one launch a coarse scale a step).  In plain PyTorch each of the
// sample_max sequential picks would be several launches; here it is one
// launch.  Contract: dmcf_tpu_torch/kernels/fps.py.
//
// What bounds it: the sample_max picks depend on each other (pick s needs
// the arg-max of the distances to picks 0..s-1), so a set is a chain of
// sample_max block-wide arg-max reductions.  Its work (n distance updates a
// pick, ~9 fp32 operations each) and its bytes (the positions, read once
// into shared memory) are microseconds of the card; the chain's latency,
// one block barrier and two five-level shuffle reductions a pick, is the
// floor.  The design keeps everything of a pick on chip: the positions in
// dynamic shared memory (12 bytes a point, opted in above 48 KB; past the
// opt-in limit the same loop reads them from global memory), each thread's
// running minimum distances in registers (a strided slice of up to 8
// points on as few warps as hold the set: fewer warps, a shorter
// reduction; past 8,192 points a global workspace), and one barrier a pick:
// the warps' partial arg-maxes go to one of two shared buffers by the
// pick's parity, and every warp reduces the 32 partials itself, so no
// second barrier hands the winner out.
//
// Bitwise equal to the plain version (kernels/fps.py): the distance is
// fma(dz, dz, fma(dy, dy, dx * dx)) with dx = p - cur, the fused
// multiply-adds XLA's CPU compiler makes of JAX's sum((pos - cur) ** 2),
// written with _rn intrinsics so that nvcc fuses nothing else; the
// running minimum is exact; and the arg-max takes the largest value, the
// lowest index among equal
// ones (torch.argmax and jnp.argmax), an order on (value, -index) that
// any reduction tree gives the same way.  Masked rows hold -inf and are
// never updated, as in the plain version; positions are finite (a NaN
// would be ignored here and propagated by torch.minimum).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kItems = 8;  // minima a thread in registers; past
//                            kMaxThreads * kItems points, a workspace

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Every lane ends with the warp's (largest value, lowest index).
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// The block's arg-max, known to every thread after one barrier.  Buffer
// ``parity`` must alternate between calls (see the file note).
__device__ __forceinline__ int block_argmax(float v, int i, int parity,
                                            float (*red_v)[kMaxWarps],
                                            int (*red_i)[kMaxWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    red_v[parity][warp] = v;
    red_i[parity][warp] = i;
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
  v = lane < warps ? red_v[parity][lane] : -INFINITY;
  i = lane < warps ? red_i[parity][lane] : INT_MAX;
  warp_argmax(v, i);
  return i;
}

__device__ __forceinline__ float sq_dist(const float* p, float cx, float cy,
                                         float cz) {
  const float dx = __fsub_rn(p[0], cx);
  const float dy = __fsub_rn(p[1], cy);
  const float dz = __fsub_rn(p[2], cz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// kRegisters: each thread keeps the minima of points tid + k * blockDim
// (k < kItems) in registers, else in ``work`` [batch, n].  kShared: the
// positions staged in dynamic shared memory.
template <bool kRegisters, bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const float* __restrict__ pos,
               const unsigned char* __restrict__ mask,
               const int* __restrict__ count, int n, int sample_max,
               int* __restrict__ idx, unsigned char* __restrict__ sel,
               float* __restrict__ work) {
  extern __shared__ float staged[];
  __shared__ float red_v[2][kMaxWarps];
  __shared__ int red_i[2][kMaxWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const float* src = pos + static_cast<size_t>(b) * n * 3;
  const unsigned char* m = mask + static_cast<size_t>(b) * n;
  int* out = idx + static_cast<size_t>(b) * sample_max;
  const float* P = src;
  if constexpr (kShared) {
    for (int j = tid; j < 3 * n; j += bd) staged[j] = src[j];
    P = staged;
  }
  const int cnt = count[b];
  for (int j = tid; j < sample_max; j += bd)
    sel[static_cast<size_t>(b) * sample_max + j] = j < cnt ? 1 : 0;

  // the first pick: the lowest valid row (argmax of the mask), 0 if none
  float md[kItems];
  float* wk = kRegisters ? nullptr : work + static_cast<size_t>(b) * n;
  float fv = -INFINITY;
  int fi = INT_MAX;
  if constexpr (kRegisters) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = tid + k * bd;
      const bool valid = j < n && m[j] != 0;
      md[k] = valid ? INFINITY : -INFINITY;
      if (j < n && better(valid ? 1.0f : 0.0f, j, fv, fi)) {
        fv = valid ? 1.0f : 0.0f;
        fi = j;
      }
    }
  } else {
    for (int j = tid; j < n; j += bd) {
      const bool valid = m[j] != 0;
      wk[j] = valid ? INFINITY : -INFINITY;
      if (better(valid ? 1.0f : 0.0f, j, fv, fi)) {
        fv = valid ? 1.0f : 0.0f;
        fi = j;
      }
    }
  }
  int last = block_argmax(fv, fi, 0, red_v, red_i);
  if (tid == 0) out[0] = last;

  for (int s = 1; s < sample_max; ++s) {
    const float cx = P[3 * last], cy = P[3 * last + 1], cz = P[3 * last + 2];
    float bv = -INFINITY;
    int bi = INT_MAX;
    if constexpr (kRegisters) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int j = tid + k * bd;
        if (j < n) {
          if (md[k] != -INFINITY)  // a valid row (its minimum is >= 0)
            md[k] = fminf(md[k], sq_dist(P + 3 * j, cx, cy, cz));
          if (better(md[k], j, bv, bi)) {
            bv = md[k];
            bi = j;
          }
        }
      }
    } else {
      for (int j = tid; j < n; j += bd) {
        float d = wk[j];
        if (d != -INFINITY) {
          d = fminf(d, sq_dist(P + 3 * j, cx, cy, cz));
          wk[j] = d;
        }
        if (better(d, j, bv, bi)) {
          bv = d;
          bi = j;
        }
      }
    }
    last = block_argmax(bv, bi, s & 1, red_v, red_i);
    if (tid == 0) out[s] = last;
  }
}

template <bool kRegisters, bool kShared>
int launch(int batch, int threads, size_t smem, cudaStream_t st,
           const float* pos, const unsigned char* mask, const int* count,
           int n, int sample_max, int* idx, unsigned char* sel, float* work) {
  auto kernel = fps_kernel<kRegisters, kShared>;
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

int round_warps(int x) { return ((x + 31) / 32) * 32; }

}  // namespace

// Floats of the workspace a launch over sets of n points needs a set
// (0: the minima fit in registers).
extern "C" int fps_work_floats(int n) {
  return n > kMaxThreads * kItems ? n : 0;
}

// pos [batch, n, 3] fp32, mask [batch, n] bool, count [batch] int32 ->
// idx [batch, sample_max] int32, sel [batch, sample_max] bool (j < count);
// work: fps_work_floats(n) floats a set, or null when that is 0.
extern "C" int fps_launch(const float* pos, const unsigned char* mask,
                          const int* count, int batch, int n, int sample_max,
                          int* idx, unsigned char* sel, float* work,
                          void* stream) {
  if (batch <= 0) return 0;
  if (n < 1 || sample_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fps_work_floats(n) > 0 && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  const size_t smem = static_cast<size_t>(n) * 3 * sizeof(float);
  // the static reduction buffers share the block's shared memory
  const bool shared =
      smem + 2 * kMaxWarps * (sizeof(float) + sizeof(int)) <=
      static_cast<size_t>(optin);
  const bool registers = fps_work_floats(n) == 0;
  const int threads =
      registers ? round_warps((n + kItems - 1) / kItems) : kMaxThreads;
  if (registers)
    return shared ? launch<true, true>(batch, threads, smem, st, pos, mask,
                                       count, n, sample_max, idx, sel, work)
                  : launch<true, false>(batch, threads, 0, st, pos, mask,
                                        count, n, sample_max, idx, sel, work);
  return shared ? launch<false, true>(batch, threads, smem, st, pos, mask,
                                      count, n, sample_max, idx, sel, work)
                : launch<false, false>(batch, threads, 0, st, pos, mask,
                                       count, n, sample_max, idx, sel, work);
}
