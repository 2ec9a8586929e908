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
//   filter: dW[s*Cin + c, o] = sum_q T[q, s, c] dout[q, o]
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
// latency: the dependent idx -> feats gathers and the walk over each
// query's slots; the roofline is far below.
// - data: one block a query (8 warps).  Pass 1 marks the tap rows any slot
//   touches; pass 2 computes dT only there, one thread an element, W rows
//   from L2; pass 3 gives each warp a slot, lanes the channels, the slot's
//   <= 8 non-zero taps kept in registers, one warp reduction a tap for dA.
//   da and dt have one writer each; dfeats and dqfeats are summed with
//   float atomics, so two launches may differ in the last bits.  Plain fp32
//   FMAs.
// - filter: deterministic, on the tensor cores.  A block of 16 warps takes
//   a chunk of T's columns (tap rows x channels) and a fixed contiguous
//   range of 16-query tiles.  For each tile it builds T as the forward
//   does, with the same code (klist_taps.cuh: a warp a query, lanes owning
//   T elements, the slots walked in order, only the non-zero taps, no
//   atomics), so T is bitwise the forward's T; then it adds the tile's
//   T^T dout to register accumulators with mma.sync.m16n8k8 (TF32), the
//   tile's 16 queries the contraction depth (two k-steps), each warp
//   owning up to 16 (16 columns x 8 outputs) blocks, and skipping blocks
//   whose tap rows no query of the tile touched (zero in T).  Each k-step's
//   products start from 0 and join the accumulator with an IEEE add.  The
//   block writes its sum over its tiles as a partial into a workspace
//   [groups][S*Cin][Cout] (the wrapper allocates it with torch.empty), and
//   a second launch sums the partials over the groups in a fixed order
//   into dW (with one group the first launch writes dW itself).  The
//   groups are sized for about one block an SM, the workspace to at most
//   32 MB.  No float atomics anywhere: two launches give the same bits.
//   The wrapper's launch count is one a call, two kernels or one.
//   Rounding: fp32 variant (and the symmetric form) 3xTF32, T and dout each
//   split big + small (T_big dout_big + T_big dout_small + T_small
//   dout_big), ~fp32 accuracy; bf16 variant, T is bf16 and so exact in
//   TF32, dout is split big + small (T dout_big + T dout_small), each
//   part's error below 2^-22 relative.
// No TMA or wgmma (a later PR).
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
//   filter: T = bf16(sum_k A g), summed in fp32 and rounded once, as the
//           forward rounds it; dW = T^T dout in fp32, rounded once by the
//           caller (JAX's filter gradient is bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "klist_taps.cuh"

namespace {

using klist::bf16_val;
using klist::round_bf16;
using klist::row_set;

constexpr int kThreads = 256;   // data kernel
constexpr int kWarps = kThreads / 32;
constexpr int kFWarps = 16;     // filter: a warp a query of the tile
constexpr int kFThreads = kFWarps * 32;
constexpr int kFQ = kFWarps;    // queries a tile: the product's depth
constexpr int kFP = 16;         // (16 x 8) output blocks a warp accumulates
constexpr int kFChunkMax = 2048;  // T elements a query in one chunk
constexpr int kFBlocks = 132;   // filter blocks to aim for: one an SM
constexpr size_t kFWorkMax = size_t{1} << 23;  // partials, floats (32 MB)

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
  int Q, K, N, Cin, Cout, kz, ky, kx, S;
};

// The filter kernel's parameters: chunking of T's columns, the output
// blocks, the query tiles and their groups.
struct FParams : klist::KListIn {
  const float* dout;
  float* out;      // dW, or the partials [G][S*Cin][Cout]
  int Cout;
  int RC, CW, ncc, nchunks;  // chunks of RC tap rows x CW channels
  int LD, LDO;     // T and dout tile row strides (floats)
  int NB;          // blocks of 8 outputs
  int tiles, TPG, G;  // 16-query tiles, tiles a group, groups
  int MW;          // tap-row mask words
  int taps;        // most non-zero taps a slot can have (4 or 8)
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

// The filter gradient of one chunk of T's columns (blockIdx.y) over one
// group of query tiles (blockIdx.x), into the group's partial (see the
// note).  Shared memory: T [kFQ][LD], dout [kFQ][LDO], the warps' output
// blocks [kFWarps * kFP] (first column, first output), the tap lists
// [kFWarps][32][kTaps], the tile's touched-row mask [MW].
template <int kTaps, bool kBF16>
__global__ void __launch_bounds__(kFThreads, 1)
cconv_klist_bwd_filter_kernel(const FParams p) {
  extern __shared__ float4 smem4[];
  float* T = reinterpret_cast<float*>(smem4);
  float* dq = T + kFQ * p.LD;
  int2* blk = reinterpret_cast<int2*>(dq + kFQ * p.LDO);
  int2* taps = reinterpret_cast<int2*>(blk + kFWarps * kFP);
  unsigned* tmask = reinterpret_cast<unsigned*>(taps + kFWarps * 32 * kTaps);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int ch = blockIdx.y;
  const int rc = ch / p.ncc;
  const int s0 = rc * p.RC;
  const int nr = min(p.S, s0 + p.RC) - s0;
  const int clo = (ch - rc * p.ncc) * p.CW;
  const int cw = min(p.Cin, clo + p.CW) - clo;
  const int ce = nr * cw;
  const int npairs = (ce + 15) / 16 * p.NB;
  const int grp = blockIdx.x;
  const int t1 = min(p.tiles, (grp + 1) * p.TPG);
  // warp w owns output blocks w * kFP + j: block i = (columns mb*16..,
  // outputs nb*8..), mb = i / NB, nb = i mod NB
  for (int i = tid; i < npairs; i += kFThreads) {
    const int mb = i / p.NB;
    blk[i] = make_int2(mb * 16, (i - mb * p.NB) * 8);
  }
  float acc[kFP][4];
#pragma unroll
  for (int j = 0; j < kFP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int tile = grp * p.TPG; tile < t1; ++tile) {
    const int q0 = tile * kFQ;
    float4* T4 = reinterpret_cast<float4*>(T);
    for (int i = tid; i < kFQ * p.LD / 4; i += kFThreads)
      T4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < p.MW; i += kFThreads) tmask[i] = 0u;
    for (int i = tid; i < kFQ * p.LDO; i += kFThreads) {
      const int qi = i / p.LDO;
      const int o = i - qi * p.LDO;
      const int q = q0 + qi;
      dq[i] = q < p.Q && o < p.Cout
          ? p.dout[static_cast<size_t>(q) * p.Cout + o] : 0.0f;
    }
    __syncthreads();
    klist::build_T<kTaps, kBF16>(p, T, p.LD, taps, tmask, q0, s0, nr, clo,
                                 cw);
    __syncthreads();
    // a tile that touched no tap row of the chunk adds 0: skip it
    bool on = false;
    for (int i = 0; i < p.MW && !on; ++i) on = tmask[i] != 0u;
    if (!on) {
      __syncthreads();
      continue;
    }
    // acc += T_tile^T dout_tile: A[m][k] = T[k][m0 + m], B[k][n] =
    // dout[k][n0 + n], k the tile's 16 queries (two k-steps of 8); every
    // block of the chunk, straight-line, so the next block's loads issue
    // under this one's products
#pragma unroll
    for (int j = 0; j < kFP; ++j) {
      if (warp * kFP + j >= npairs) break;
      const int2 b = blk[warp * kFP + j];
      float av[2][4];
      uint32_t bb[2][2], bs[2][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {  // both k-steps' operands first
        const float* Tk = T + (ks * 8 + tq) * p.LD + b.x + g;
        const float* Dk = dq + (ks * 8 + tq) * p.LDO + b.y + g;
        av[ks][0] = Tk[0];
        av[ks][1] = Tk[8];
        av[ks][2] = Tk[4 * p.LD];
        av[ks][3] = Tk[4 * p.LD + 8];
        klist::split(Dk[0], bb[ks][0], bs[ks][0]);
        klist::split(Dk[4 * p.LDO], bb[ks][1], bs[ks][1]);
      }
      // the two k-steps' products interleaved: two independent chains
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if (kBF16) {  // T rounded to bf16 as the forward rounds it: exact
        uint32_t at[2][4];  // in TF32
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            at[ks][e] = __float_as_uint(round_bf16(av[ks][e]));
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) klist::mma_tf32(c[ks], at[ks], bs[ks]);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) klist::mma_tf32(c[ks], at[ks], bb[ks]);
      } else {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            klist::split(av[ks][e], ab[ks][e], as[ks][e]);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) klist::mma_tf32(c[ks], as[ks], bb[ks]);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) klist::mma_tf32(c[ks], ab[ks], bs[ks]);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) klist::mma_tf32(c[ks], ab[ks], bb[ks]);
      }
      // each k-step's products join the sum with an IEEE add, in order
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = (acc[j][e] + c[0][e]) + c[1][e];
    }
    __syncthreads();  // the next tile rewrites T, dout and the mask
  }

  float* out = p.out
      + static_cast<size_t>(grp) * p.S * p.Cin * p.Cout;
  const size_t base = static_cast<size_t>(s0) * p.Cin + clo;
#pragma unroll
  for (int j = 0; j < kFP; ++j) {
    if (warp * kFP + j >= npairs) break;
    const int2 b = blk[warp * kFP + j];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = b.x + g + (e >> 1) * 8;
      const int o = b.y + 2 * tq + (e & 1);
      if (m < ce && o < p.Cout) out[(base + m) * p.Cout + o] = acc[j][e];
    }
  }
}

// dW = the sum of the G partials [G][n], group 0 first: a fixed order.
// Eight partials' loads are in flight before they are added.
__global__ void __launch_bounds__(128)
cconv_klist_bwd_filter_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, int groups,
                                  size_t n) {
  constexpr int kBatch = 8;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x
           + threadIdx.x; i < n; i += stride) {
    float s = part[i];
    for (int g0 = 1; g0 < groups; g0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = g0 + u < groups ? part[(g0 + u) * n + i] : 0.0f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (g0 + u < groups) s += v[u];
    }
    dw[i] = s;
  }
}

size_t data_smem(const Params& p) {
  return 4 * (static_cast<size_t>(p.S) * p.Cin + p.Cout + (p.S + 31) / 32);
}

size_t filter_smem(const FParams& p) {
  return 4 * (static_cast<size_t>(kFQ) * (p.LD + p.LDO) + p.MW)
      + 8 * static_cast<size_t>(kFWarps) * kFP
      + 8 * static_cast<size_t>(kFWarps) * 32 * p.taps;
}

bool valid_shape(int K, int N, int Cin, int Cout, int kz, int ky, int kx) {
  const int S = kz * ky * kx;
  return K > 0 && N > 0 && Cin > 0 && Cout > 0 && Cout <= 256 && kz > 0 &&
         ky > 0 && kx > 0 && S <= 1024 && S * Cin <= 8192;
}

// The shape fields both kernels' parameters have; false for a shape the
// kernels do not take.
template <typename P>
bool plan(P& p, int Q, int K, int N, int Cin, int Cout, int kz, int ky,
          int kx) {
  if (!valid_shape(K, N, Cin, Cout, kz, ky, kx)) return false;
  p.Q = Q;
  p.K = K;
  p.N = N;
  p.Cin = Cin;
  p.Cout = Cout;
  p.kz = kz;
  p.ky = ky;
  p.kx = kx;
  p.S = kz * ky * kx;
  return true;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

bool filter_plan(FParams& p, int Q, int K, int N, int Cin, int Cout, int kz,
                 int ky, int kx) {
  if (!plan(p, Q, K, N, Cin, Cout, kz, ky, kx)) return false;
  p.NB = (Cout + 7) / 8;
  // a chunk's (16 x 8) output blocks fit the warps' accumulators
  const int ce_max = std::min(kFChunkMax, 16 * (kFWarps * kFP / p.NB));
  if (Cin <= ce_max) {
    p.RC = std::min(ce_max / Cin, p.S);
    p.CW = Cin;
    p.ncc = 1;
  } else {  // one tap row is wider than a chunk: chunks of channels
    p.RC = 1;
    p.CW = ce_max;
    p.ncc = (Cin + ce_max - 1) / ce_max;
  }
  p.tiles = std::max(1, (Q + kFQ - 1) / kFQ);
  if (p.ncc == 1) {  // few tiles: thinner chunks, so more blocks run
    const int want = (kFBlocks + p.tiles - 1) / p.tiles;
    p.RC = std::min(p.RC, std::max(1, (p.S + want - 1) / want));
  }
  p.nchunks = (p.S + p.RC - 1) / p.RC * p.ncc;
  p.LD = round_up(p.RC * p.CW, 32) + 8;  // + 8: conflict-free fragments
  p.LDO = round_up(Cout, 32) + 8;
  p.MW = (p.RC + 31) / 32;
  p.taps = kz == 1 || ky == 1 || kx == 1 ? 4 : 8;
  const size_t dw_floats = static_cast<size_t>(p.S) * Cin * Cout;
  int groups = std::min(p.tiles,
                        std::max(1, (kFBlocks + p.nchunks - 1) / p.nchunks));
  groups = static_cast<int>(std::min(
      static_cast<size_t>(groups),
      std::max(size_t{1}, kFWorkMax / dw_floats)));
  p.TPG = (p.tiles + groups - 1) / groups;
  p.G = (p.tiles + p.TPG - 1) / p.TPG;
  return true;
}

template <typename Kernel, typename P>
int launch(Kernel kernel, dim3 blocks, int threads, size_t smem, const P& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  Shapes as the forward's
// (cconv_klist_launch) plus dout [Q, Cout]; all contiguous, idx int32, the
// rest fp32 but, with bf16 != 0 (the bf16 variant, qfeats null), feats and
// w bf16.  Requires kz*ky*kx <= 1024, kz*ky*kx*Cin <= 8192,
// 1 <= Cout <= 256, K, N >= 1.  Each returns the CUDA error code of its
// launch (0 on success).
//
// Data: dfeats [N, Cin] and dqfeats [Q, Cin] (null unless qfeats is given)
// are ADDED into (the caller zeroes them); da [Q, K] and dt [Q, K, 3] are
// written.
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
    return launch(cconv_klist_bwd_data_kernel<true>, dim3(Q), kThreads,
                  data_smem(p), p, st);
  }
  p.feats = static_cast<const float*>(feats);
  p.w = static_cast<const float*>(w);
  return launch(cconv_klist_bwd_data_kernel<false>, dim3(Q), kThreads,
                data_smem(p), p, st);
}

// Filter: floats of the workspace the launch below needs for this shape (0:
// none), or -1 for a shape it does not take.
extern "C" long long cconv_klist_bwd_filter_workspace(int Q, int K, int N,
                                                      int Cin, int Cout,
                                                      int kz, int ky,
                                                      int kx) {
  FParams p{};
  if (!filter_plan(p, Q, K, N, Cin, Cout, kz, ky, kx)) return -1;
  if (Q <= 0 || p.G == 1) return 0;
  return static_cast<long long>(p.G) * p.S * Cin * Cout;
}

// dw [kz*ky*kx*Cin, Cout] is written; work holds the workspace's floats
// (cconv_klist_bwd_filter_workspace; null when it needs none).  One kernel
// launch, or two when the workspace is used.
extern "C" int cconv_klist_bwd_filter_launch(
    const int* idx, const float* a, const float* t, const void* feats,
    const float* qfeats, const float* dout, float* dw, float* work, int Q,
    int K, int N, int Cin, int Cout, int kz, int ky, int kx, int bf16,
    void* stream) {
  if (Q <= 0) return 0;
  FParams p{};
  if (!filter_plan(p, Q, K, N, Cin, Cout, kz, ky, kx) || (bf16 && qfeats) ||
      (p.G > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  p.idx = idx;
  p.a = a;
  p.t = t;
  p.qfeats = qfeats;
  p.dout = dout;
  p.out = p.G > 1 ? work : dw;
  if (bf16)
    p.feats_h = static_cast<const uint16_t*>(feats);
  else
    p.feats = static_cast<const float*>(feats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(p.G, p.nchunks);
  const size_t smem = filter_smem(p);
  int err;
  if (bf16)
    err = p.taps == 4
        ? launch(cconv_klist_bwd_filter_kernel<4, true>, grid, kFThreads,
                 smem, p, st)
        : launch(cconv_klist_bwd_filter_kernel<8, true>, grid, kFThreads,
                 smem, p, st);
  else
    err = p.taps == 4
        ? launch(cconv_klist_bwd_filter_kernel<4, false>, grid, kFThreads,
                 smem, p, st)
        : launch(cconv_klist_bwd_filter_kernel<8, false>, grid, kFThreads,
                 smem, p, st);
  if (err != 0 || p.G == 1) return err;
  const size_t n = static_cast<size_t>(p.S) * Cin * Cout;
  const int blocks = static_cast<int>(
      std::min(static_cast<size_t>(8 * kFBlocks), (n + 127) / 128));
  cconv_klist_bwd_filter_sum_kernel<<<blocks, 128, 0, st>>>(work, dw, p.G,
                                                            n);
  return static_cast<int>(cudaGetLastError());
}
