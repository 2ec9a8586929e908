// Backward of the K-list continuous convolution for Hopper (sm_90a), in the
// forward's two variants: fp32, and bf16 (the JAX package's default
// precision).
//
// The forward is csrc/cconv_klist.cu.  No TPU kernel is replaced: the JAX
// package trains by XLA autodiff of dmcf_tpu/ops/cconv.py:continuous_conv
// (:173-322), so the reference for these kernels is that function's VJP.
// With, for each query q and slot k,
//
//   A[k, s] = H[k, s] * a[k],  H[k, s] = (hz(t[k,0])[iz] * hy(t[k,1])[iy])
//                                        * hx(t[k,2])[ix]
//   g[k, c] = feats[clamp(idx[k]), c] (+ qfeats[q, c], symmetric conv)
//   T[s, c] = sum_k A[k, s] g[k, c],   out[q, :] = vec(T) @ W
//
// and dout [Q, Cout] given, the two kernels compute
//
//   data:   dT[s, c]   = sum_o W[s*Cin + c, o] dout[q, o]   (touched rows)
//           dg[k, c]   = sum_s A[k, s] dT[s, c]
//           dfeats[clamp(idx[k])] += dg[k]      (float atomics)
//           dqfeats[q] += sum_k dg[k]           (float atomics; symmetric)
//           dA[k, s]   = sum_c dT[s, c] g[k, c]
//           da[k]      = sum_s dA[k, s] H[k, s]
//           dt[k, ax]  = a[k] sum_s dA[k, s] dH[k, s] / dt[k, ax]
//   filter: dW[s*Cin + c, o] = sum_q T[q, s, c] dout[q, o]  (float atomics)
//
// The hats' derivative follows PyTorch autograd of the plain twin
// (kernels/cconv_klist.py, relu(1 - |clamp(t, -h, h) - p|)), which is the
// convention of cconv_klist_bwd_reference:
//   clamp'(t) = 1 for -h <= t <= h (bounds included), else 0;
//   |u|'      = sign(u), 0 at u = 0;
//   relu'(v)  = 1 for v > 0, else 0 (so a tap of weight 0 has derivative 0).
// JAX differs at the kinks (|u|'(0) = 1, a clip's gradient 1/2 at a bound):
// on a 2D config the size-1 z axis sits on both, so the gradient in t_z
// differs (JAX -1/4 a hat, here 0); t_z is z scaled by 0, so neither the
// positions' nor the parameters' gradients differ (ROADMAP §3).
//
// An index past the end reads row N-1 in the forward, so its gradient lands
// in row N-1 (a negative one in row 0): the derivative of the forward.
// JAX's gather VJP drops such slots instead (ROADMAP §3).
//
// What bounds it on the H100 (WaterRamps trunk conv, Q 2688, K 40, S 64,
// Cin 32, Cout 32): ~4 MB of inputs and outputs (~1.3 us of HBM); the work
// the data needs (dT on the ~40 touched tap rows a query, 4 taps a slot)
// is ~0.2 GFLOP, a few us at the fp32 rate.  What bounds these kernels is
// latency and atomics, not the roofline:
// - data: one block a query (8 warps).  Pass 1 marks the tap rows any slot
//   touches; pass 2 computes dT only there, one thread an element, W rows
//   from L2; pass 3 gives each warp a slot, lanes the channels, the slot's
//   <= 8 non-zero taps kept in registers, one warp reduction a tap for dA.
//   da and dt have one writer each; dfeats and dqfeats are summed with
//   float atomics, so two launches may differ in the last bits.
// - filter: one block a tile of QT <= 32 queries, QT sized for about two
//   blocks an SM (the momentum model's K 256 convs have 80 queries).  T is
//   rebuilt per tile from the forward's non-zero taps, in chunks of tap
//   rows: the 8 warps take the tile's (query, slot) pairs in turn, lanes
//   the channels, and add into T with shared-memory atomics; the tile's
//   product over the rows a query touched is added into dW with one float
//   atomic an element a tile.  Two launches may differ in the last bits.
// Plain fp32 FMAs throughout; no tensor cores, TMA or wgmma (a later PR).
//
// The bf16 variant (template flag kBF16; feats and W arrive as bf16, no
// symmetric form) is the derivative of the bf16 forward, rounded where
// JAX's VJP of its fast_bf16 contraction rounds (dmcf_tpu/ops/cconv.py
// :279-312): A = bf16(H a) and g = bf16(feats) as in the forward;
//   data:   dT = bf16(sum_o W16 dout)            (rounded once)
//           dA = bf16(sum_c dT g)                (rounded once a tap)
//           dg = sum_s A dT, added into dfeats in fp32; the caller rounds
//           dfeats to bf16 once.  JAX rounds each slot's dg to bf16 and
//           scatter-adds them in bf16 (ROADMAP §3).
//   filter: T = bf16(sum_k A g), rebuilt with shared-memory atomics and
//           then rounded; dW = T^T dout in fp32, rounded once by the caller
//           (JAX's filter gradient is bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFQ = 32;    // most queries in a filter-kernel tile
constexpr int kFE = 512;   // T elements per query in one filter chunk

struct Params {
  const int* idx;
  const float* a;
  const float* t;
  const float* feats;        // fp32 variant
  const float* qfeats;
  const float* w;
  const uint16_t* feats_h;   // bf16 variant: the bits of bf16 values
  const uint16_t* w_h;
  const float* dout;
  float* dfeats;
  float* dqfeats;
  float* da;
  float* dt;
  float* dw;
  int Q, K, N, Cin, Cout, kz, ky, kx, S;
  int RC, CW, ncc, nchunks;  // filter chunking: RC tap rows x CW channels
  int QT;                    // filter tile: queries a block
};

// The <= 2 non-zero hats of one axis (taps i0, i0 + 1; cnt in range) with
// their derivatives in t.  i0 and the weights are the forward's (exact
// floor by a round-down add, the twin's expression).
struct Axis {
  int i0, cnt;
  float w[2], d[2];
};

__device__ __forceinline__ Axis axis_taps(float t, int n) {
  const float half = 0.5f * (n - 1);
  const float tc = fminf(fmaxf(t, -half), half);
  const bool inside = t >= -half && t <= half;
  Axis r;
  r.i0 = min(static_cast<int>(floorf(__fadd_rd(tc, half))), n - 1);
  r.cnt = r.i0 + 1 < n ? 2 : 1;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    r.w[j] = 0.0f;
    r.d[j] = 0.0f;
    if (j < r.cnt) {
      const float u = tc - (static_cast<float>(r.i0 + j) - half);
      const float v = 1.0f - fabsf(u);
      r.w[j] = fmaxf(v, 0.0f);
      if (inside && v > 0.0f)
        r.d[j] = u > 0.0f ? -1.0f : (u < 0.0f ? 1.0f : 0.0f);
    }
  }
  return r;
}

// One slot's taps whose three axis weights are all non-zero (every other
// tap has H = 0 and zero derivative): row, H and dH/dt per axis.  Tap
// (jz, jy, jx) of the 2x2x2 candidates sits at i = 4 jz + 2 jy + jx, bit i
// of ``on`` set when it counts: every index is a compile-time constant in
// the unrolled loops, so the arrays stay in registers.
struct Taps {
  unsigned on;
  int row[8];
  float h[8], gz[8], gy[8], gx[8];
};

__device__ __forceinline__ bool tap_on(const Taps& tp, int i) {
  return (tp.on >> i) & 1u;
}

__device__ __forceinline__ Taps slot_taps(const Params& p, float tz, float ty,
                                          float tx) {
  const Axis z = axis_taps(tz, p.kz);
  const Axis y = axis_taps(ty, p.ky);
  const Axis x = axis_taps(tx, p.kx);
  Taps tp;
  tp.on = 0u;
#pragma unroll
  for (int jz = 0; jz < 2; ++jz)
#pragma unroll
    for (int jy = 0; jy < 2; ++jy)
#pragma unroll
      for (int jx = 0; jx < 2; ++jx) {
        const int i = 4 * jz + 2 * jy + jx;
        tp.row[i] = 0;
        tp.h[i] = tp.gz[i] = tp.gy[i] = tp.gx[i] = 0.0f;
        if (jz >= z.cnt || jy >= y.cnt || jx >= x.cnt) continue;
        if (z.w[jz] == 0.0f || y.w[jy] == 0.0f || x.w[jx] == 0.0f) continue;
        tp.on |= 1u << i;
        tp.row[i] = ((z.i0 + jz) * p.ky + y.i0 + jy) * p.kx + x.i0 + jx;
        tp.h[i] = (z.w[jz] * y.w[jy]) * x.w[jx];  // the twin's order
        tp.gz[i] = (z.d[jz] * y.w[jy]) * x.w[jx];
        tp.gy[i] = (z.w[jz] * y.d[jy]) * x.w[jx];
        tp.gx[i] = (z.w[jz] * y.w[jy]) * x.d[jx];
      }
  return tp;
}

// bf16 bits -> fp32 (exact) and fp32 -> bf16 (round to nearest even)
__device__ __forceinline__ float bf16_val(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The variant's tap weight A = H a (rounded to bf16 in the bf16 variant).
template <bool kBF16>
__device__ __forceinline__ float tap_weight(float h, float a) {
  return kBF16 ? round_bf16(h * a) : h * a;
}

// A feature read (bf16 values widened exactly in the bf16 variant).
template <bool kBF16>
__device__ __forceinline__ float feat(const Params& p, size_t e) {
  return kBF16 ? bf16_val(p.feats_h[e]) : p.feats[e];
}

__device__ __forceinline__ bool row_set(const unsigned* m, int r) {
  return (m[r >> 5] >> (r & 31)) & 1u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Data gradients: one block a query.  Shared memory: dT [S*Cin], dout
// [Cout], the touched-row mask [ceil(S/32)].
template <bool kBF16>
__global__ void __launch_bounds__(kThreads)
cconv_klist_bwd_data_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* dT = reinterpret_cast<float*>(smem4);
  float* dq = dT + p.S * p.Cin;
  unsigned* mask = reinterpret_cast<unsigned*>(dq + p.Cout);
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t qk = static_cast<size_t>(q) * p.K;

  for (int i = tid; i < (p.S + 31) / 32; i += kThreads) mask[i] = 0u;
  for (int o = tid; o < p.Cout; o += kThreads)
    dq[o] = p.dout[static_cast<size_t>(q) * p.Cout + o];
  __syncthreads();
  // pass 1: the tap rows any slot touches (empty slots too: da needs them)
  for (int k = tid; k < p.K; k += kThreads) {
    const float* tk = p.t + 3 * (qk + k);
    const Taps tp = slot_taps(p, tk[0], tk[1], tk[2]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (tap_on(tp, j))
        atomicOr(mask + (tp.row[j] >> 5), 1u << (tp.row[j] & 31));
  }
  __syncthreads();
  // pass 2: dT on the touched rows (W rows read as float4 when Cout % 4
  // == 0: each thread's row is whole cache lines)
  for (int e = tid; e < p.S * p.Cin; e += kThreads) {
    if (!row_set(mask, e / p.Cin)) continue;
    float s = 0.0f;
    if (kBF16) {  // 4 bf16 values a load when Cout % 4 == 0
      const uint16_t* wr = p.w_h + static_cast<size_t>(e) * p.Cout;
      if ((p.Cout & 3) == 0 &&
          (reinterpret_cast<uintptr_t>(p.w_h) & 7) == 0) {
        const uint2* w4 = reinterpret_cast<const uint2*>(wr);
        for (int o = 0; o < p.Cout / 4; ++o) {
          const uint2 v = __ldg(w4 + o);
          s = fmaf(__uint_as_float(v.x << 16), dq[4 * o], s);
          s = fmaf(__uint_as_float(v.x & 0xffff0000u), dq[4 * o + 1], s);
          s = fmaf(__uint_as_float(v.y << 16), dq[4 * o + 2], s);
          s = fmaf(__uint_as_float(v.y & 0xffff0000u), dq[4 * o + 3], s);
        }
      } else {
        for (int o = 0; o < p.Cout; ++o)
          s = fmaf(bf16_val(__ldg(wr + o)), dq[o], s);
      }
      dT[e] = round_bf16(s);
      continue;
    }
    const float* wr = p.w + static_cast<size_t>(e) * p.Cout;
    if ((p.Cout & 3) == 0 && (reinterpret_cast<uintptr_t>(p.w) & 15) == 0) {
      const float4* w4 = reinterpret_cast<const float4*>(wr);
      for (int o = 0; o < p.Cout / 4; ++o) {
        const float4 v = __ldg(w4 + o);
        s = fmaf(v.x, dq[4 * o], s);
        s = fmaf(v.y, dq[4 * o + 1], s);
        s = fmaf(v.z, dq[4 * o + 2], s);
        s = fmaf(v.w, dq[4 * o + 3], s);
      }
    } else {
      for (int o = 0; o < p.Cout; ++o) s = fmaf(__ldg(wr + o), dq[o], s);
    }
    dT[e] = s;
  }
  __syncthreads();
  // pass 3: a warp a slot, lanes over the channels
  for (int k = warp; k < p.K; k += kWarps) {
    const size_t e = qk + k;
    const float ak = p.a[e];
    const Taps tp = slot_taps(p, p.t[3 * e], p.t[3 * e + 1], p.t[3 * e + 2]);
    const int row = min(max(p.idx[e], 0), p.N - 1);
    float dA[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) dA[j] = 0.0f;
    for (int cb = 0; cb < p.Cin; cb += 32) {
      const int c = cb + lane;
      if (c >= p.Cin) break;
      float g = feat<kBF16>(p, static_cast<size_t>(row) * p.Cin + c);
      if (p.qfeats != nullptr)
        g += p.qfeats[static_cast<size_t>(q) * p.Cin + c];
      float dg = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!tap_on(tp, j)) continue;
        const float dtv = dT[tp.row[j] * p.Cin + c];
        dA[j] = fmaf(dtv, g, dA[j]);
        dg = fmaf(tap_weight<kBF16>(tp.h[j], ak), dtv, dg);
      }
      if (ak != 0.0f && tp.on != 0u) {  // an empty slot adds exactly 0
        atomicAdd(p.dfeats + static_cast<size_t>(row) * p.Cin + c, dg);
        if (p.qfeats != nullptr)
          atomicAdd(p.dqfeats + static_cast<size_t>(q) * p.Cin + c, dg);
      }
    }
    float das = 0.0f, dz = 0.0f, dy = 0.0f, dx = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!tap_on(tp, j)) continue;  // uniform across the warp
      float v = warp_sum(dA[j]);
      if (kBF16) v = round_bf16(v);
      das = fmaf(v, tp.h[j], das);
      dz = fmaf(v, tp.gz[j], dz);
      dy = fmaf(v, tp.gy[j], dy);
      dx = fmaf(v, tp.gx[j], dx);
    }
    if (lane == 0) {
      p.da[e] = das;
      p.dt[3 * e] = dz * ak;
      p.dt[3 * e + 1] = dy * ak;
      p.dt[3 * e + 2] = dx * ak;
    }
  }
}

// Filter gradient: one block a tile of QT queries.  Shared memory: T
// [QT][kFE], dout [QT][Cout], the chunk's touched-row mask.
template <bool kBF16>
__global__ void __launch_bounds__(kThreads)
cconv_klist_bwd_filter_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* T = reinterpret_cast<float*>(smem4);
  float* dq = T + p.QT * kFE;
  unsigned* mask = reinterpret_cast<unsigned*>(dq + p.QT * p.Cout);
  const int q0 = blockIdx.x * p.QT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int mw = (p.RC + 31) / 32;

  for (int i = tid; i < p.QT * p.Cout; i += kThreads) {
    const int q = q0 + i / p.Cout;
    dq[i] = q < p.Q ? p.dout[static_cast<size_t>(q0) * p.Cout + i] : 0.0f;
  }
  for (int ch = 0; ch < p.nchunks; ++ch) {
    const int rc = ch / p.ncc;
    const int s0 = rc * p.RC;
    const int nr = min(p.S, s0 + p.RC) - s0;
    const int clo = (ch - rc * p.ncc) * p.CW;
    const int cw = min(p.Cin, clo + p.CW) - clo;
    for (int i = tid; i < p.QT * kFE; i += kThreads) T[i] = 0.0f;
    for (int i = tid; i < mw; i += kThreads) mask[i] = 0u;
    __syncthreads();
    // T from the forward's non-zero taps, a warp a (query, slot) pair
    for (int pk = warp; pk < p.QT * p.K; pk += kWarps) {
      const int qi = pk / p.K;
      const int k = pk - qi * p.K;
      const int q = q0 + qi;
      if (q >= p.Q) break;  // pk grows, so every later pair is past Q too
      float* Tq = T + qi * kFE;
      const size_t e = static_cast<size_t>(q) * p.K + k;
      const float ak = p.a[e];
      if (ak == 0.0f) continue;
      const Taps tp = slot_taps(p, p.t[3 * e], p.t[3 * e + 1],
                                p.t[3 * e + 2]);
      const int row = min(max(p.idx[e], 0), p.N - 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float wt = tap_weight<kBF16>(tp.h[j], ak);
        const int r = tp.row[j] - s0;
        if (!tap_on(tp, j) || wt == 0.0f || r < 0 || r >= nr) continue;
        if (lane == 0) atomicOr(mask + (r >> 5), 1u << (r & 31));
        for (int c = lane; c < cw; c += 32) {
          float g = feat<kBF16>(p, static_cast<size_t>(row) * p.Cin + clo
                                + c);
          if (p.qfeats != nullptr)
            g += p.qfeats[static_cast<size_t>(q) * p.Cin + clo + c];
          atomicAdd(Tq + r * cw + c, wt * g);
        }
      }
    }
    __syncthreads();
    if (kBF16) {  // T's sums complete: round them as the forward does
      for (int i = tid; i < p.QT * kFE; i += kThreads)
        T[i] = round_bf16(T[i]);
      __syncthreads();
    }
    // the tile's product over the touched rows, added into dW
    const int ne = nr * cw;
    for (int i = tid; i < ne * p.Cout; i += kThreads) {
      const int el = i / p.Cout;
      const int o = i - el * p.Cout;
      const int r = el / cw;
      if (!row_set(mask, r)) continue;
      float s = 0.0f;
      for (int qi = 0; qi < p.QT; ++qi)
        s = fmaf(T[qi * kFE + el], dq[qi * p.Cout + o], s);
      const size_t wrow = static_cast<size_t>(s0 + r) * p.Cin + clo
          + (el - r * cw);
      atomicAdd(p.dw + wrow * p.Cout + o, s);
    }
    __syncthreads();
  }
}

size_t data_smem(const Params& p) {
  return 4 * (static_cast<size_t>(p.S) * p.Cin + p.Cout + (p.S + 31) / 32);
}

size_t filter_smem(const Params& p) {
  return 4 * (static_cast<size_t>(p.QT) * kFE + p.QT * p.Cout
              + (p.RC + 31) / 32);
}

bool plan(Params& p, int Q, int K, int N, int Cin, int Cout, int kz, int ky,
          int kx) {
  const int S = kz * ky * kx;
  if (K <= 0 || N <= 0 || Cin <= 0 || Cout <= 0 || Cout > 256 || kz <= 0 ||
      ky <= 0 || kx <= 0 || S > 1024 || S * Cin > 8192)
    return false;
  p.Q = Q;
  p.K = K;
  p.N = N;
  p.Cin = Cin;
  p.Cout = Cout;
  p.kz = kz;
  p.ky = ky;
  p.kx = kx;
  p.S = S;
  if (Cin <= kFE) {
    p.RC = kFE / Cin < S ? kFE / Cin : S;
    p.CW = Cin;
    p.ncc = 1;
  } else {  // one tap row is wider than the chunk: chunks of channels
    p.RC = 1;
    p.CW = kFE;
    p.ncc = (Cin + kFE - 1) / kFE;
  }
  p.nchunks = (S + p.RC - 1) / p.RC * p.ncc;
  // about two filter blocks an SM of the H100's 132, at most kFQ queries
  p.QT = min(kFQ, max(1, (Q + 263) / 264));
  return true;
}

template <typename Kernel>
int launch(Kernel kernel, int blocks, size_t smem, const Params& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  Shapes as the forward's
// (cconv_klist_launch) plus dout [Q, Cout]; all contiguous, idx int32, the
// rest fp32 but, with bf16 != 0 (the bf16 variant, qfeats null), feats and
// w bf16.  Outputs, fp32: dfeats [N, Cin] and dqfeats [Q, Cin] (null
// unless qfeats is given) are ADDED into (the caller zeroes them); da
// [Q, K] and dt [Q, K, 3] are written; dw [kz*ky*kx*Cin, Cout] is added
// into.  Requires kz*ky*kx <= 1024, kz*ky*kx*Cin <= 8192, 1 <= Cout <= 256,
// K, N >= 1.  Each returns the CUDA error code of its launch (0 on
// success).
extern "C" int cconv_klist_bwd_data_launch(
    const int* idx, const float* a, const float* t, const void* feats,
    const float* qfeats, const void* w, const float* dout, float* dfeats,
    float* dqfeats, float* da, float* dt, int Q, int K, int N, int Cin,
    int Cout, int kz, int ky, int kx, int bf16, void* stream) {
  if (Q <= 0) return 0;
  Params p{};
  if (!plan(p, Q, K, N, Cin, Cout, kz, ky, kx))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((qfeats == nullptr) != (dqfeats == nullptr) ||
      (bf16 && qfeats != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  p.idx = idx;
  p.a = a;
  p.t = t;
  p.qfeats = qfeats;
  p.dout = dout;
  p.dfeats = dfeats;
  p.dqfeats = dqfeats;
  p.da = da;
  p.dt = dt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    p.feats_h = static_cast<const uint16_t*>(feats);
    p.w_h = static_cast<const uint16_t*>(w);
    return launch(cconv_klist_bwd_data_kernel<true>, Q, data_smem(p), p, st);
  }
  p.feats = static_cast<const float*>(feats);
  p.w = static_cast<const float*>(w);
  return launch(cconv_klist_bwd_data_kernel<false>, Q, data_smem(p), p, st);
}

extern "C" int cconv_klist_bwd_filter_launch(
    const int* idx, const float* a, const float* t, const void* feats,
    const float* qfeats, const float* dout, float* dw, int Q, int K, int N,
    int Cin, int Cout, int kz, int ky, int kx, int bf16, void* stream) {
  if (Q <= 0) return 0;
  Params p{};
  if (!plan(p, Q, K, N, Cin, Cout, kz, ky, kx) || (bf16 && qfeats))
    return static_cast<int>(cudaErrorInvalidValue);
  p.idx = idx;
  p.a = a;
  p.t = t;
  p.qfeats = qfeats;
  p.dout = dout;
  p.dw = dw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (Q + p.QT - 1) / p.QT;
  if (bf16) {
    p.feats_h = static_cast<const uint16_t*>(feats);
    return launch(cconv_klist_bwd_filter_kernel<true>, blocks,
                  filter_smem(p), p, st);
  }
  p.feats = static_cast<const float*>(feats);
  return launch(cconv_klist_bwd_filter_kernel<false>, blocks,
                filter_smem(p), p, st);
}
