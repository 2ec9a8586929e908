// K-list continuous convolution for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel dmcf_tpu/experimental/pallas_cconv.py
// `pallas_continuous_conv` (pallas_call at :193, body `_kernel` :95), whose
// XLA twin `dmcf_tpu/ops/cconv.py:continuous_conv` is what the JAX model
// runs.  For each query q:
//
//   A[k, s]  = ((hz(t[k,0])[iz] * hy(t[k,1])[iy]) * hx(t[k,2])[ix]) * a[k]
//   T[s, c]  = sum_k A[k, s] * (feats[idx[k], c] (+ qfeats[q, c]))
//   out[q,:] = vec(T) @ W                               W: [S*Cin, Cout]
//
// with the per-axis hat weights in the bitwise mirror-exact form
// relu(1 - |clamp(t, -h, h) - (i - h)|), h = (size-1)/2, on the *centred*
// filter coordinates t (ball->cube mapping done outside, as the Pallas
// kernel also leaves it outside).  The products are taken in the same order
// as the reference's tap tensor, so A is bitwise equal to it.  The
// symmetric (ASCC) self term is folded in as (f_k + f_q), as in the Pallas
// kernel.  `idx` must be in range: the Python wrapper clamps it.
//
// What bounds it on the H100 (WaterRamps trunk conv, Q 2688, K 40, S 64,
// Cin 32, Cout 32): it must read idx/a/t (Q*K*20 B = 2.2 MB), the feature
// rows (N*Cin*4 B, 0.34 MB; the gather touches Q*K*Cin*4 B = 13.8 MB through
// L2), W (S*Cin*Cout*4 B = 0.26 MB) and write out (0.34 MB): ~3 MB, ~1 us of
// HBM.  The arithmetic is the dense accumulate 2*Q*K*S*Cin = 0.44 GFLOP plus
// the filter product 2*Q*S*Cin*Cout = 0.35 GFLOP in fp32 without tensor
// cores (67 TFLOP/s): ~12 us.  So the op is arithmetic- and latency-bound,
// not bandwidth-bound, at this size.
//
// What this simple design does about it: one block of 256 threads owns QB
// queries.  The taps of 16 neighbour slots and their gathered feature rows
// are staged in shared memory, and each thread accumulates NE entries of T
// in registers, so the [Q, K, S] tap tensor and the [Q, K, Cin] gather never
// reach device memory.  The QB finished T tiles then share one pass over W
// (read once per block instead of once per query, coalesced along Cout).
// Not done yet: skipping the zero taps (a 2D hat has 4 of 64 non-zero),
// tensor cores for the filter product, asynchronous staging of the gather.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 16;  // neighbour slots staged per shared-memory tile

__device__ __forceinline__ float hat(float t, float half, int i) {
  const float tc = fminf(fmaxf(t, -half), half);
  return fmaxf(1.0f - fabsf(tc - (static_cast<float>(i) - half)), 0.0f);
}

// NE: T entries per thread (S*Cin <= NE*kThreads); QB: queries per block.
template <int NE, int QB>
__global__ void __launch_bounds__(kThreads)
cconv_klist_kernel(const int* __restrict__ idx, const float* __restrict__ a,
                   const float* __restrict__ t,
                   const float* __restrict__ feats,
                   const float* __restrict__ qfeats,
                   const float* __restrict__ w, float* __restrict__ out,
                   int Q, int K, int Cin, int Cout, int kz, int ky, int kx) {
  extern __shared__ float smem[];
  const int S = kz * ky * kx;
  const int SC = S * Cin;
  float* A_sh = smem;                  // [kSlots][S]
  float* g_sh = A_sh + kSlots * S;     // [kSlots][Cin]
  float* T_sh = g_sh + kSlots * Cin;   // [QB][SC]
  float* red = T_sh + QB * SC;         // [npart][QB][Cout]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const float hz = 0.5f * (kz - 1);
  const float hy = 0.5f * (ky - 1);
  const float hx = 0.5f * (kx - 1);
  const int kyx = ky * kx;

  int s_of[NE], c_of[NE];
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    const int e = tid + j * kThreads;
    s_of[j] = e < SC ? e / Cin : 0;
    c_of[j] = e < SC ? e - (e / Cin) * Cin : 0;
  }

  for (int qi = 0; qi < QB; ++qi) {
    const int q = q0 + qi;
    float acc[NE];
#pragma unroll
    for (int j = 0; j < NE; ++j) acc[j] = 0.0f;
    if (q < Q) {  // uniform across the block: the barriers below are safe
      const size_t row = static_cast<size_t>(q) * K;
      for (int k0 = 0; k0 < K; k0 += kSlots) {
        const int nk = min(kSlots, K - k0);
        for (int i = tid; i < nk * S; i += kThreads) {
          const int k = i / S;
          const int s = i - k * S;
          const int iz = s / kyx;
          const int r = s - iz * kyx;
          const int iy = r / kx;
          const int ix = r - iy * kx;
          const float* tp = t + (row + k0 + k) * 3;
          const float wzy = hat(tp[0], hz, iz) * hat(tp[1], hy, iy);
          const float wzyx = wzy * hat(tp[2], hx, ix);
          A_sh[k * S + s] = wzyx * a[row + k0 + k];
        }
        for (int i = tid; i < nk * Cin; i += kThreads) {
          const int k = i / Cin;
          const int c = i - k * Cin;
          float g = feats[static_cast<size_t>(idx[row + k0 + k]) * Cin + c];
          if (qfeats != nullptr) g += qfeats[static_cast<size_t>(q) * Cin + c];
          g_sh[i] = g;
        }
        __syncthreads();
        for (int k = 0; k < nk; ++k) {
#pragma unroll
          for (int j = 0; j < NE; ++j)
            acc[j] = fmaf(A_sh[k * S + s_of[j]], g_sh[k * Cin + c_of[j]],
                          acc[j]);
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const int e = tid + j * kThreads;
      if (e < SC) T_sh[qi * SC + e] = acc[j];
    }
  }
  __syncthreads();

  // out[q, o] = sum_e T[q, e] * W[e, o]: thread (part, o) walks every
  // npart-th row of W once for all QB queries of the block
  const int npart = kThreads / Cout;
  const int o = tid % Cout;
  const int part = tid / Cout;
  if (part < npart) {
    float y[QB];
#pragma unroll
    for (int qi = 0; qi < QB; ++qi) y[qi] = 0.0f;
    for (int e = part; e < SC; e += npart) {
      const float wv = w[static_cast<size_t>(e) * Cout + o];
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) y[qi] = fmaf(T_sh[qi * SC + e], wv, y[qi]);
    }
#pragma unroll
    for (int qi = 0; qi < QB; ++qi) red[(part * QB + qi) * Cout + o] = y[qi];
  }
  __syncthreads();
  for (int i = tid; i < QB * Cout; i += kThreads) {
    const int qi = i / Cout;
    const int oo = i - qi * Cout;
    const int q = q0 + qi;
    if (q < Q) {
      float sum = 0.0f;
      for (int p = 0; p < npart; ++p) sum += red[(p * QB + qi) * Cout + oo];
      out[static_cast<size_t>(q) * Cout + oo] = sum;
    }
  }
}

template <int NE, int QB>
int launch(const int* idx, const float* a, const float* t, const float* feats,
           const float* qfeats, const float* w, float* out, int Q, int K,
           int Cin, int Cout, int kz, int ky, int kx, cudaStream_t stream) {
  const int S = kz * ky * kx;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kSlots) * (S + Cin) +
       static_cast<size_t>(QB) * S * Cin + static_cast<size_t>(kThreads) * QB);
  auto kernel = cconv_klist_kernel<NE, QB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (Q + QB - 1) / QB;
  kernel<<<blocks, kThreads, smem, stream>>>(idx, a, t, feats, qfeats, w, out,
                                             Q, K, Cin, Cout, kz, ky, kx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  Shapes: idx/a [Q,K], t [Q,K,3] (tz,ty,tx),
// feats [N,Cin], qfeats [Q,Cin] or null, w [kz*ky*kx*Cin, Cout], out [Q,Cout];
// all contiguous, idx int32 in [0, N), the rest fp32.  Requires
// kz*ky*kx <= 1024, kz*ky*kx*Cin <= 8192 and 1 <= Cout <= 256.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int cconv_klist_launch(const int* idx, const float* a,
                                  const float* t, const float* feats,
                                  const float* qfeats, const float* w,
                                  float* out, int Q, int K, int Cin, int Cout,
                                  int kz, int ky, int kx, void* stream) {
  const int S = kz * ky * kx;
  const int SC = S * Cin;
  if (Q <= 0) return 0;
  if (K <= 0 || Cin <= 0 || Cout <= 0 || Cout > kThreads || S <= 0 ||
      S > 1024 || SC > 32 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DMCF_LAUNCH(NE, QB) \
  launch<NE, QB>(idx, a, t, feats, qfeats, w, out, Q, K, Cin, Cout, kz, ky, \
                 kx, st)
  if (SC <= 1 * kThreads) return DMCF_LAUNCH(1, 8);
  if (SC <= 2 * kThreads) return DMCF_LAUNCH(2, 8);
  if (SC <= 4 * kThreads) return DMCF_LAUNCH(4, 8);
  if (SC <= 8 * kThreads) return DMCF_LAUNCH(8, 4);
  if (SC <= 16 * kThreads) return DMCF_LAUNCH(16, 2);
  return DMCF_LAUNCH(32, 1);
#undef DMCF_LAUNCH
}
