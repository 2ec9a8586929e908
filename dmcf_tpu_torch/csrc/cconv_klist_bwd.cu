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
//           dfeats[r]  = sum of dg[k] over the slots (q, k) of every query
//                        with clamp(idx[k]) = r and a[k] != 0, in
//                        ascending q*K + k
//           dqfeats[q] = sum_s (sum_k A[k, s]) dT[s, :]   (symmetric)
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
// - data: a memset and three kernels, deterministic, no float atomics.
//   dT (cconv_klist_bwd_dT_kernel): a block takes a tile of 16 queries
//   and a chunk of W's rows (chunks thin enough for ~2 blocks an SM).  It
//   marks the chunk's tap rows any slot of the tile touches (empty slots
//   too: da needs them), then forms dT = dout_tile W^T on the tensor cores
//   (mma.sync.m16n8k8 TF32: the 16 queries as M, 8 rows of W a block as N,
//   Cout the depth, so a lane stores two consecutive elements of dT) for
//   the 16-row blocks of W that hold a marked row: W is read once a tile,
//   not once a query.  dT goes to a workspace [Q][S*Cin] the wrapper
//   allocates (bf16 in the bf16 variant, whose dT values are bf16).
//   Rounding: fp32 variant 3xTF32 (W and dout split big + small), bf16
//   variant W exact in TF32 against dout big + small; each k-step's
//   products join the fp32 sum with an IEEE add.  Its sums run in another
//   order than a serial fp32 product, so ~1e-4 of the bf16 variant's dT
//   lands one bf16 step from the plain version's (counted in the checks).
//   The same kernel counts each feats row's slots with a != 0 (integer
//   atomics) and its last block to finish scans the counts into offsets.
//   Query side (cconv_klist_bwd_walk_kernel): a lane takes a slot, its
//   <= 8 non-zero taps in registers, and sums dA of each tap over the
//   channels alone (four a load): 32 slots' gathers in flight a warp and
//   no shuffles (the first layout, a lane group a slot and the channels
//   over its lanes, spent ~0.12 ms at the trunk on dependent loads and
//   reductions).  da and dt have one writer each.  It files each slot
//   with a != 0 into its row's run of the transposed list (integer
//   atomics: in no set order).  With qfeats a warp a query forms
//   dqfeats[q] = sum_s (sum_k A[k, s]) dT[s, :], a per-query sum in a
//   fixed order.
//   Source side (cconv_klist_bwd_dfeats_kernel): a warp takes a row of
//   feats and its run (the padded slots, idx 0 and a 0, are not in it),
//   sorts the run's slot ids ascending (by rank in shared memory up to
//   512 slots, by a bitonic network in place past it), recomputes each
//   slot's taps from t and a and adds dg = sum_j A_j dT[q, row_j, :]
//   (lanes the channels) to the row's sum, slot by slot in ascending id.
//   The dT workspace, not a per-slot dg one: dT is Q*S*Cin elements, dg
//   Q*K*Cin (22 MB against 13.8 MB at the trunk, but 4.3 MB against 170
//   MB at Cin 8192, and smaller at K 96 and beyond).  Every output element
//   has one writer and a fixed order: two launches give the same bits.
//   A stable sort of the clamped idx instead (PyTorch's) took longer on an
//   H100 than the three kernels together: hence the counts.
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
// Interpolation (klist_taps.cuh): both kernels take the forward's three
// modes.  The filter kernel builds T by the forward's walk, its mode a
// template parameter.  The data kernels recompute each slot's taps with
// their derivatives (axis_taps below; the mode a parameter of the launch):
// linear_border takes the hats' sign rule of linear without its clamp (so
// no gate on t inside the span); nearest_neighbor has one tap of weight 1
// an axis and derivative 0, as PyTorch's (and JAX's) gradient of round
// and == is, so dt is 0 and da comes from the one tap.
//
// The bf16 variant (template flag kBF16; feats and W arrive as bf16, no
// symmetric form) is the derivative of the bf16 forward, rounded where
// JAX's VJP of its fast_bf16 contraction rounds (dmcf_tpu/ops/cconv.py
// :279-312): A = bf16(H a) and g = bf16(feats) as in the forward;
//   data:   dT = bf16(sum_o W16 dout)            (rounded once)
//           dA = bf16(sum_c dT g)                (rounded once a tap)
//           dg = sum_s A dT, summed into dfeats in fp32; the caller
//           rounds dfeats to bf16 once.  JAX rounds each slot's dg to bf16 and
//           scatter-adds them in bf16 (ROADMAP §3).
//   filter: T = bf16(sum_k A g), summed in fp32 and rounded once, as the
//           forward rounds it; dW = T^T dout in fp32, rounded once by the
//           caller (JAX's filter gradient is bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "klist_taps.cuh"

namespace {

using klist::bf16_val;
using klist::round_bf16;
using klist::row_set;

constexpr int kDWarps = 8;      // data kernels: warps a block
constexpr int kDThreads = kDWarps * 32;
constexpr int kDQ = 16;         // dT: queries a tile, the product's M
constexpr int kDBlocks = 264;   // dT blocks to aim for: two an SM
constexpr int kDKB = 4;         // dT: k-steps whose W loads are in flight
//                                 (fp32; bf16: one, measured faster)
constexpr int kSortCap = 512;   // dfeats: a row's slots sorted in shared
//                                 memory (in place past it)
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
  int* order;                // slot ids by the feats row they read
  int* offsets;              // [N + 1]: row r's are order[offsets[r]..]
  int* ctr;                  // [N + 1]: the rows' counts, then fill
  //                            counters; [N] the dT blocks' ticket
  float* work;               // dT [Q][S*Cin], fp32 variant
  uint16_t* work_h;          // bf16 variant: the bits of bf16 values
  float* dfeats;
  float* dqfeats;
  float* da;
  float* dt;
  int Q, K, N, Cin, Cout, kz, ky, kx, S;
  int SC;      // S*Cin: W's rows, a query's dT
  int LDO;     // dout tile row stride (words)
  int MW;      // tap-row mask words
  int MBC;     // dT: 16-row blocks of W a chunk
  int wpair;   // W's pairs loadable whole (Cout even, aligned)
  int vec4;    // feats, qfeats and dT rows loadable 4 channels at once
  int interp;  // the interpolation mode (klist::Interp)
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
  int taps;        // most non-zero taps a slot can have (1, 4 or 8)
};

// The <= 2 non-zero taps of one axis (i0, i0 + 1; cnt in range) of the
// mode ``interp`` with their derivatives in t.  i0 and the weights are
// the forward's (klist::axis_taps: the exact floor by a round-down add,
// the twin's expression); the derivative is the hats' sign rule, gated on
// t inside the span for linear (the clamp's derivative), 0 for nearest.
struct Axis {
  int i0, cnt;
  float w[2], d[2];
};

__device__ __forceinline__ Axis axis_taps(float t, int n, int interp) {
  const float half = 0.5f * (n - 1);
  klist::Axis k;
  if (interp == klist::kNearest)
    k = klist::axis_taps<klist::kNearest>(t, n);
  else if (interp == klist::kLinearBorder)
    k = klist::axis_taps<klist::kLinearBorder>(t, n);
  else
    k = klist::axis_taps<klist::kLinear>(t, n);
  const float tc = interp == klist::kLinear ? fminf(fmaxf(t, -half), half)
                                            : t;
  const bool moves = interp == klist::kLinearBorder
      || (interp == klist::kLinear && t >= -half && t <= half);
  Axis r;
  r.i0 = k.i0;
  r.cnt = k.cnt;
  r.w[0] = k.w0;
  r.w[1] = k.w1;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    r.d[j] = 0.0f;
    if (j < r.cnt && moves) {
      const float u = tc - (static_cast<float>(r.i0 + j) - half);
      if (1.0f - fabsf(u) > 0.0f)
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
  const Axis z = axis_taps(tz, p.kz, p.interp);
  const Axis y = axis_taps(ty, p.ky, p.interp);
  const Axis x = axis_taps(tx, p.kx, p.interp);
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

// Marks in ``mask`` the rows in [lo, hi] of the warp's slots' taps (each
// lane its slot): one OR-reduction and one atomic per mask word.
__device__ __forceinline__ void mark_rows(const Taps& tp, unsigned* mask,
                                          int lo, int hi) {
  const int lane = threadIdx.x & 31;
  unsigned on = 0u;
  int wlo = klist::kMaxWords, whi = -1;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (tap_on(tp, j) && tp.row[j] >= lo && tp.row[j] <= hi) {
      on |= 1u << j;
      wlo = min(wlo, tp.row[j] >> 5);
      whi = max(whi, tp.row[j] >> 5);
    }
  wlo = __reduce_min_sync(0xffffffffu, wlo);
  whi = __reduce_max_sync(0xffffffffu, whi);
  for (int wd = wlo; wd <= whi; ++wd) {
    unsigned m = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (((on >> j) & 1u) && (tp.row[j] >> 5) == wd)
        m |= 1u << (tp.row[j] & 31);
    m = __reduce_or_sync(0xffffffffu, m);
    if (lane == 0 && m != 0u) atomicOr(mask + wd, m);
  }
}

// W[r][k] and W[r][k + 1], 0 past the ends: one 8-byte (fp32) or 4-byte
// (bf16) load where the pair is whole and aligned.
template <bool kBF16>
__device__ __forceinline__ void w_pair(const Params& p, int r, int k,
                                       float& x, float& y) {
  x = y = 0.0f;
  if (r >= p.SC) return;
  const size_t e = static_cast<size_t>(r) * p.Cout + k;
  const bool whole = k + 1 < p.Cout;
  if (kBF16) {
    if (whole && p.wpair) {
      const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p.w_h + e));
      x = __uint_as_float(v << 16);
      y = __uint_as_float(v & 0xffff0000u);
    } else {
      if (k < p.Cout) x = bf16_val(__ldg(p.w_h + e));
      if (whole) y = bf16_val(__ldg(p.w_h + e + 1));
    }
  } else {
    if (whole && p.wpair) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(p.w + e));
      x = v.x;
      y = v.y;
    } else {
      if (k < p.Cout) x = __ldg(p.w + e);
      if (whole) y = __ldg(p.w + e + 1);
    }
  }
}

// An element of the dT workspace (bf16 values in the bf16 variant).
template <bool kBF16>
__device__ __forceinline__ float dT_at(const Params& p, size_t e) {
  return kBF16 ? bf16_val(p.work_h[e]) : p.work[e];
}

// offsets[0..n] = the exclusive prefix sums of counts[0..n) (offsets[n]
// their total), by one block: a thread a contiguous run of rows, the runs'
// sums scanned through shared memory.
__device__ void scan_counts(const int* counts, int* offsets, int n) {
  __shared__ int sums[kDThreads];
  const int tid = threadIdx.x;
  const int run = (n + kDThreads - 1) / kDThreads;
  const int lo = min(n, tid * run);
  const int hi = min(n, lo + run);
  int s = 0;
  for (int r = lo; r < hi; ++r) s += __ldcg(counts + r);
  sums[tid] = s;
  __syncthreads();
  for (int off = 1; off < kDThreads; off <<= 1) {  // inclusive scan
    const int v = tid >= off ? sums[tid - off] : 0;
    __syncthreads();
    sums[tid] += v;
    __syncthreads();
  }
  s = sums[tid] - s;  // exclusive
  for (int r = lo; r < hi; ++r) {
    offsets[r] = s;
    s += __ldcg(counts + r);
  }
  if (tid == kDThreads - 1) offsets[n] = sums[tid];
}

// Data gradients, step 1: dT[q][e] = sum_o W[e][o] dout[q][o] for a tile
// of kDQ queries (blockIdx.x) over a chunk of W's rows (blockIdx.y: MBC
// blocks of 16 rows), on the tensor cores, into the workspace.  Only the
// 16-row blocks that hold a tap row some slot of the tile touches (empty
// slots too: da needs them) are formed.  The first chunk's blocks count
// the rows' listed slots; the last block to finish makes the offsets.
// Shared memory: dout tile split big + small [2][kDQ][LDO], the tile's
// tap-row mask [MW].
template <bool kBF16>
__global__ void __launch_bounds__(kDThreads)
cconv_klist_bwd_dT_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  uint32_t* db = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* dsm = db + kDQ * p.LDO;
  unsigned* tmask = dsm + kDQ * p.LDO;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kDQ;
  const int mb0 = blockIdx.y * p.MBC;
  const int mb1 = min((p.SC + 15) >> 4, mb0 + p.MBC);
  const int slo = (mb0 << 4) / p.Cin;
  const int shi = (min(mb1 << 4, p.SC) - 1) / p.Cin;

  for (int i = tid; i < p.MW; i += kDThreads) tmask[i] = 0u;
  for (int i = tid; i < kDQ * p.LDO; i += kDThreads) {
    const int n = i / p.LDO;
    const int o = i - n * p.LDO;
    const int q = q0 + n;
    klist::split(q < p.Q && o < p.Cout
                 ? p.dout[static_cast<size_t>(q) * p.Cout + o] : 0.0f,
                 db[i], dsm[i]);
  }
  __syncthreads();
  for (int n = warp; n < kDQ; n += kDWarps) {
    const int q = q0 + n;
    if (q >= p.Q) break;
    for (int k0 = 0; k0 < p.K; k0 += 32) {
      Taps tp;
      tp.on = 0u;
      if (k0 + lane < p.K) {
        const size_t e = static_cast<size_t>(q) * p.K + k0 + lane;
        tp = slot_taps(p, p.t[3 * e], p.t[3 * e + 1], p.t[3 * e + 2]);
        if (blockIdx.y == 0 && p.a[e] != 0.0f)  // the rows' counts
          atomicAdd(p.ctr + min(max(p.idx[e], 0), p.N - 1), 1);
      }
      mark_rows(tp, tmask, slo, shi);
    }
  }
  __syncthreads();
  const int g = lane >> 2;
  const int tq = lane & 3;
  // C [16 queries][16 rows of W] = A B: A[m][kk] = dout[q0 + m][.], B[kk][n]
  // = W[m0 + n][.], as two n8 blocks; depth kk = tq holds output ka, kk =
  // tq + 4 output ka + 1 (any order of the depth serves, A and B take the
  // same), so a lane's A and B values are pairs of consecutive outputs
  const bool pairs = (p.SC & 1) == 0;  // dT pairs aligned for one store
  for (int mb = mb0 + warp; mb < mb1; mb += kDWarps) {
    const int m0 = mb << 4;
    bool on = false;
    for (int s = m0 / p.Cin; s <= (min(m0 + 16, p.SC) - 1) / p.Cin && !on;
         ++s)
      on = row_set(tmask, s);
    if (!on) continue;  // uniform across the warp
    float acc[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] = 0.0f;
    constexpr int kKB = kBF16 ? 1 : kDKB;
    for (int kb = 0; kb < p.Cout; kb += 8 * kKB) {
      float w[kKB][2][2];  // [k-step][n8 block][kk = tq, tq + 4]
#pragma unroll
      for (int u = 0; u < kKB; ++u)  // kKB k-steps' W loads in flight
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          w_pair<kBF16>(p, m0 + 8 * nb + g, kb + 8 * u + 2 * tq, w[u][nb][0],
                        w[u][nb][1]);
#pragma unroll
      for (int u = 0; u < kKB; ++u) {
        if (kb + 8 * u >= p.Cout) break;
        const int ka = kb + 8 * u + 2 * tq;
        // A's fragment: (g, tq), (g + 8, tq), (g, tq + 4), (g + 8, tq + 4)
        const uint2 b0 = *reinterpret_cast<const uint2*>(db + g * p.LDO + ka);
        const uint2 b8 = *reinterpret_cast<const uint2*>(
            db + (g + 8) * p.LDO + ka);
        const uint2 s0 = *reinterpret_cast<const uint2*>(
            dsm + g * p.LDO + ka);
        const uint2 s8 = *reinterpret_cast<const uint2*>(
            dsm + (g + 8) * p.LDO + ka);
        const uint32_t ab[4] = {b0.x, b8.x, b0.y, b8.y};
        const uint32_t as[4] = {s0.x, s8.x, s0.y, s8.y};
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t bb[2], bs[2];
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          if (kBF16) {  // a bf16 value: exact in TF32
            bb[0] = __float_as_uint(w[u][nb][0]);
            bb[1] = __float_as_uint(w[u][nb][1]);
            klist::mma_tf32(c, as, bb);
            klist::mma_tf32(c, ab, bb);
          } else {
            klist::split(w[u][nb][0], bb[0], bs[0]);
            klist::split(w[u][nb][1], bb[1], bs[1]);
            klist::mma_tf32(c, as, bb);
            klist::mma_tf32(c, ab, bs);
            klist::mma_tf32(c, ab, bb);
          }
          // each k-step's products join the sum with an IEEE add
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nb][e] += c[e];
        }
      }
    }
    // C's fragment: (g, 2 tq), (g, 2 tq + 1), (g + 8, 2 tq), (g + 8,
    // 2 tq + 1): each lane two consecutive dT elements of two queries
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = q0 + g + 8 * h;
        const int m = m0 + 8 * nb + 2 * tq;
        if (q >= p.Q || m >= p.SC) continue;
        const size_t i = static_cast<size_t>(q) * p.SC + m;
        const float x = acc[nb][2 * h];
        const float y = acc[nb][2 * h + 1];
        const bool both = m + 1 < p.SC;
        if (kBF16) {
          const uint32_t hx = __bfloat16_as_ushort(__float2bfloat16_rn(x));
          const uint32_t hy = __bfloat16_as_ushort(__float2bfloat16_rn(y));
          if (both && pairs) {
            *reinterpret_cast<uint32_t*>(p.work_h + i) = hx | (hy << 16);
          } else {
            p.work_h[i] = static_cast<uint16_t>(hx);
            if (both) p.work_h[i + 1] = static_cast<uint16_t>(hy);
          }
        } else if (both && pairs) {
          *reinterpret_cast<float2*>(p.work + i) = make_float2(x, y);
        } else {
          p.work[i] = x;
          if (both) p.work[i + 1] = y;
        }
      }
  }

  // the last block to finish turns the rows' counts into offsets
  __shared__ int last;
  __threadfence();  // this thread's counts before the block's ticket
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(p.ctr + p.N, 1)
        == static_cast<int>(gridDim.x * gridDim.y) - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    scan_counts(p.ctr, p.offsets, p.N);
  }
}

// Four consecutive channels of a feats row, of a query's qfeats or of the
// dT workspace: one 16-byte (fp32) or 8-byte (bf16) load.
template <bool kBF16>
__device__ __forceinline__ float4 feat4(const Params& p, size_t e) {
  if (!kBF16) return *reinterpret_cast<const float4*>(p.feats + e);
  const uint2 v = *reinterpret_cast<const uint2*>(p.feats_h + e);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

template <bool kBF16>
__device__ __forceinline__ float4 dT4(const Params& p, size_t e) {
  if (!kBF16) return *reinterpret_cast<const float4*>(p.work + e);
  const uint2 v = *reinterpret_cast<const uint2*>(p.work_h + e);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// Data gradients, step 2: the query side.  A lane takes a slot (a block
// kDThreads consecutive slot ids): its <= 8 non-zero taps in registers,
// dA of each tap summed over the channels in order by the lane alone (four
// channels a load where Cin % 4 == 0), rounded to bf16 once in the bf16
// variant; da and dt have the lane as their one writer.  With qfeats, the
// blocks past the slots' take a query a warp and form dqfeats[q] = sum_s
// (sum_k A[k, s]) dT[s, :]: the tap rows' sums slot by slot in order (a
// lane each of a slot's taps, distinct rows), then the rows in ascending
// order.  Shared
// memory (qfeats only): per warp the rows' sums [S] and its slots' taps
// [32][8].
template <bool kBF16>
__global__ void __launch_bounds__(kDThreads)
cconv_klist_bwd_walk_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const long long slots = static_cast<long long>(p.Q) * p.K;
  const long long sblocks = (slots + kDThreads - 1) / kDThreads;
  if (blockIdx.x < sblocks) {
    const long long e = static_cast<long long>(blockIdx.x) * kDThreads
        + threadIdx.x;
    if (e >= slots) return;
    const int q = static_cast<int>(e / p.K);
    const float ak = p.a[e];
    const Taps tp = slot_taps(p, p.t[3 * e], p.t[3 * e + 1], p.t[3 * e + 2]);
    const int row = min(max(p.idx[e], 0), p.N - 1);
    if (ak != 0.0f)  // into the row's run of the list, in no set order
      p.order[p.offsets[row] + atomicSub(p.ctr + row, 1) - 1] =
          static_cast<int>(e);
    const size_t fr = static_cast<size_t>(row) * p.Cin;
    const size_t qs = static_cast<size_t>(q) * p.SC;
    const float* qf = p.qfeats == nullptr ? nullptr
        : p.qfeats + static_cast<size_t>(q) * p.Cin;
    float dA[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) dA[j] = 0.0f;
    if (tp.on != 0u && p.vec4) {
      for (int c = 0; c < p.Cin; c += 4) {
        float4 g = feat4<kBF16>(p, fr + c);
        if (qf != nullptr) {
          const float4 v = *reinterpret_cast<const float4*>(qf + c);
          g = make_float4(g.x + v.x, g.y + v.y, g.z + v.z, g.w + v.w);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (tap_on(tp, j)) {
            const float4 d = dT4<kBF16>(p, qs + tp.row[j] * p.Cin + c);
            dA[j] = fmaf(d.x, g.x, dA[j]);
            dA[j] = fmaf(d.y, g.y, dA[j]);
            dA[j] = fmaf(d.z, g.z, dA[j]);
            dA[j] = fmaf(d.w, g.w, dA[j]);
          }
      }
    } else if (tp.on != 0u) {
      for (int c = 0; c < p.Cin; ++c) {
        float g = feat<kBF16>(p, fr + c);
        if (qf != nullptr) g += qf[c];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (tap_on(tp, j))
            dA[j] = fmaf(dT_at<kBF16>(p, qs + tp.row[j] * p.Cin + c), g,
                         dA[j]);
      }
    }
    float das = 0.0f, dz = 0.0f, dy = 0.0f, dx = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!tap_on(tp, j)) continue;
      const float v = kBF16 ? round_bf16(dA[j]) : dA[j];
      das = fmaf(v, tp.h[j], das);
      dz = fmaf(v, tp.gz[j], dz);
      dy = fmaf(v, tp.gy[j], dy);
      dx = fmaf(v, tp.gx[j], dx);
    }
    p.da[e] = das;
    p.dt[3 * e] = dz * ak;
    p.dt[3 * e + 1] = dy * ak;
    p.dt[3 * e + 2] = dx * ak;
    return;
  }

  // dqfeats: the blocks past the slots', a warp a query
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long qw = (blockIdx.x - sblocks) * kDWarps + warp;
  if (p.qfeats == nullptr || qw >= p.Q) return;
  const int q = static_cast<int>(qw);
  const size_t qk = static_cast<size_t>(q) * p.K;
  const size_t qs = static_cast<size_t>(q) * p.SC;
  float* rs = reinterpret_cast<float*>(smem4) + warp * p.S;
  int2* sc = reinterpret_cast<int2*>(reinterpret_cast<float*>(smem4)
                                     + kDWarps * p.S) + warp * 32 * 8;
  for (int s = lane; s < p.S; s += 32) rs[s] = 0.0f;
  for (int k0 = 0; k0 < p.K; k0 += 32) {
    const int k = k0 + lane;
    Taps tp;
    tp.on = 0u;
    float ak = 0.0f;
    if (k < p.K) {
      const size_t e = qk + k;
      ak = p.a[e];
      tp = slot_taps(p, p.t[3 * e], p.t[3 * e + 1], p.t[3 * e + 2]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sc[lane * 8 + j] = tap_on(tp, j)
          ? make_int2(tp.row[j], __float_as_int(tap_weight<false>(tp.h[j],
                                                                  ak)))
          : make_int2(-1, 0);
    __syncwarp();
    const int m = min(32, p.K - k0);
    for (int i = 0; i < m; ++i) {  // the slots in order; a slot's taps are
      if (lane < 8) {              // distinct rows: a lane a tap
        const int2 te = sc[i * 8 + lane];
        if (te.x >= 0) rs[te.x] += __int_as_float(te.y);
      }
      __syncwarp();
    }
  }
  for (int cb = 0; cb < p.Cin; cb += 32) {
    const int c = min(cb + lane, p.Cin - 1);
    float acc = 0.0f;
    for (int s0 = 0; s0 < p.S; s0 += 8) {  // eight rows' loads in flight
      float d[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        d[u] = s0 + u < p.S ? p.work[qs + (s0 + u) * p.Cin + c] : 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        // 0 for a row no slot touched, whose dT is unset: skipped
        const float v = s0 + u < p.S ? rs[s0 + u] : 0.0f;
        if (v != 0.0f) acc = fmaf(v, d[u], acc);
      }
    }
    if (cb + lane < p.Cin)
      p.dqfeats[static_cast<size_t>(q) * p.Cin + cb + lane] = acc;
  }
}

// Sorts buf[0, n) ascending, by the warp: a bitonic network over the next
// power of two (each merge's first step pairs mirrored positions, so every
// step puts the smaller value first), the positions past n taken as +inf
// and their pairs skipped.  buf is in shared or global memory.
__device__ void warp_sort(int* buf, int n) {
  const int lane = threadIdx.x & 31;
  int pw = 1;
  while (pw < n) pw <<= 1;
  for (int size = 2; size <= pw; size <<= 1) {
    for (int half = size >> 1, first = 1; half > 0; half >>= 1, first = 0) {
      for (int i = lane; i < pw / 2; i += 32) {
        const int blk = i / half;
        const int off = i - blk * half;
        const int a = first ? blk * size + off : blk * 2 * half + off;
        const int b = first ? blk * size + size - 1 - off : a + half;
        if (b < n) {
          const int x = buf[a];
          const int y = buf[b];
          if (x > y) {
            buf[a] = y;
            buf[b] = x;
          }
        }
      }
      __syncwarp();
    }
  }
}

// Sorts the distinct ids src[0, n) ascending into dst, by the warp: each
// id goes to its rank, the count of smaller ids (n <= kSortCap; both in
// shared memory).  No barrier between steps, so on the short runs the
// model's lists give it takes less time than warp_sort on the same copy
// (scripts/torch_redesign_variants.py, variant bitonic); warp_sort stays
// for the long runs, where n^2 compares would not do.
__device__ void rank_sort(const int* src, int* dst, int n) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < n; i += 32) {
    const int x = src[i];
    int r = 0;
    for (int j = 0; j < n; ++j) r += src[j] < x;
    dst[r] = x;
  }
  __syncwarp();
}

// Data gradients, step 3: the source side.  A warp takes a row r of feats
// and its run of the transposed list (the slots that read it with a !=
// 0, filed in no set order), sorts the run's slot ids ascending (in shared
// memory, ranks; in place by a bitonic network past kSortCap) and stores
// it sorted.  Then, for each 32 channels, each round of 32 slots: a lane
// takes a slot, recomputes its taps from t and a (A = H a, rounded to bf16
// in the bf16 variant) and forms its dg = sum_j A_j dT[q, row_j, :] (taps
// in order; four channels a load where Cin % 4 == 0), all 32 slots' loads
// in flight, into shared memory; the lanes, as channels, then add the 32
// dg rows to the row's sum in ascending slot id.  Shared memory: per warp
// the run and its sorted copy [2][kSortCap], the round's dg [32][33].
template <bool kBF16>
__global__ void __launch_bounds__(kDThreads)
cconv_klist_bwd_dfeats_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* sb = reinterpret_cast<int*>(smem4) + warp * 2 * kSortCap;
  int* sorted = sb + kSortCap;
  float* dgs = reinterpret_cast<float*>(smem4) + kDWarps * 2 * kSortCap
      + warp * 32 * 33;
  const int r = blockIdx.x * kDWarps + warp;
  if (r >= p.N) return;
  const int beg = p.offsets[r];
  const int len = p.offsets[r + 1] - beg;
  int* run = p.order + beg;
  if (len <= kSortCap) {
    for (int i = lane; i < len; i += 32) sb[i] = run[i];
    __syncwarp();
    rank_sort(sb, sorted, len);
    for (int i = lane; i < len; i += 32) run[i] = sorted[i];
  } else {
    warp_sort(run, len);
  }
  const int* list = len <= kSortCap ? sorted : run;
  for (int cb = 0; cb < p.Cin; cb += 32) {
    const int cw = min(32, p.Cin - cb);
    float acc = 0.0f;
    for (int i0 = 0; i0 < len; i0 += 32) {
      const int m = min(32, len - i0);
      if (lane < m) {  // this lane's slot: dg over the chunk's channels
        const size_t e = static_cast<size_t>(list[i0 + lane]);
        const float ak = p.a[e];
        const Taps tp = slot_taps(p, p.t[3 * e], p.t[3 * e + 1],
                                  p.t[3 * e + 2]);
        const size_t qs = (e / p.K) * p.SC + cb;
        float* dg = dgs + lane * 33;
        if (p.vec4) {
          for (int c = 0; c < cw; c += 4) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (tap_on(tp, j)) {
                const float wt = tap_weight<kBF16>(tp.h[j], ak);
                const float4 d = dT4<kBF16>(p, qs + tp.row[j] * p.Cin + c);
                v = make_float4(fmaf(wt, d.x, v.x), fmaf(wt, d.y, v.y),
                                fmaf(wt, d.z, v.z), fmaf(wt, d.w, v.w));
              }
            dg[c] = v.x;
            dg[c + 1] = v.y;
            dg[c + 2] = v.z;
            dg[c + 3] = v.w;
          }
        } else {
          for (int c = 0; c < cw; ++c) {
            float v = 0.0f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (tap_on(tp, j))
                v = fmaf(tap_weight<kBF16>(tp.h[j], ak),
                         dT_at<kBF16>(p, qs + tp.row[j] * p.Cin + c), v);
            dg[c] = v;
          }
        }
      }
      __syncwarp();
      if (lane < cw)
        for (int i = 0; i < m; ++i) acc += dgs[i * 33 + lane];  // in order
      __syncwarp();  // the next round rewrites dg
    }
    if (lane < cw) p.dfeats[static_cast<size_t>(r) * p.Cin + cb + lane] = acc;
  }
}

// The filter gradient of one chunk of T's columns (blockIdx.y) over one
// group of query tiles (blockIdx.x), into the group's partial (see the
// note).  Shared memory: T [kFQ][LD], dout [kFQ][LDO], the warps' output
// blocks [kFWarps * kFP] (first column, first output), the tap lists
// [kFWarps][32][kTaps], the tile's touched-row mask [MW].
template <int kMode, int kTaps, bool kBF16>
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
    klist::build_T<kMode, kTaps, kBF16>(p, T, p.LD, taps, tmask, q0, s0,
                                        nr, clo, cw);
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

size_t dT_smem(const Params& p) {
  return 8 * static_cast<size_t>(kDQ) * p.LDO + 4 * p.MW;
}

size_t walk_smem(const Params& p) {
  if (p.qfeats == nullptr) return 0;
  return 4 * static_cast<size_t>(kDWarps) * p.S
      + 8 * static_cast<size_t>(kDWarps) * 32 * 8;
}

size_t dfeats_smem(const Params&) {
  return 4 * static_cast<size_t>(kDWarps) * (2 * kSortCap + 32 * 33);
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

bool data_plan(Params& p, int Q, int K, int N, int Cin, int Cout, int kz,
               int ky, int kx) {
  if (Q < 0 || !plan(p, Q, K, N, Cin, Cout, kz, ky, kx) ||
      static_cast<long long>(Q) * K > INT_MAX)  // int32 slot ids
    return false;
  p.SC = p.S * Cin;
  p.LDO = round_up(Cout, 32) + 8;  // + 8: conflict-free B fragments
  p.MW = (p.S + 31) / 32;
  // few tiles: thinner chunks of W, so more blocks run
  const int nmb = (p.SC + 15) / 16;
  const int tiles = std::max(1, (Q + kDQ - 1) / kDQ);
  const int want = (kDBlocks + tiles - 1) / tiles;
  p.MBC = round_up((nmb + want - 1) / want, kDWarps);
  return true;
}

// The data launch's workspace: dT [Q][S*Cin] (fp32, or bf16 in the bf16
// variant), then the rows' counters [N + 1] (256-byte aligned).
size_t ctr_at(const Params& p, int bf16) {
  return (static_cast<size_t>(p.Q) * p.SC * (bf16 ? 2 : 4) + 255) / 256
      * 256;
}

size_t data_work_bytes(const Params& p, int bf16) {
  return ctr_at(p, bf16) + 4 * (static_cast<size_t>(p.N) + 1);
}

bool filter_plan(FParams& p, int Q, int K, int N, int Cin, int Cout, int kz,
                 int ky, int kx, int interp) {
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
  p.taps = klist::max_taps(interp, kz, ky, kx);
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

// The filter kernel of the mode and the plan's tap count.
template <bool kBF16>
int launch_filter(const FParams& p, int interp, dim3 grid, size_t smem,
                  cudaStream_t st) {
  using klist::kLinear;
  using klist::kLinearBorder;
  using klist::kNearest;
  if (interp == kNearest)
    return launch(cconv_klist_bwd_filter_kernel<kNearest, 1, kBF16>, grid,
                  kFThreads, smem, p, st);
  if (interp == kLinearBorder)
    return p.taps == 4
        ? launch(cconv_klist_bwd_filter_kernel<kLinearBorder, 4, kBF16>,
                 grid, kFThreads, smem, p, st)
        : launch(cconv_klist_bwd_filter_kernel<kLinearBorder, 8, kBF16>,
                 grid, kFThreads, smem, p, st);
  return p.taps == 4
      ? launch(cconv_klist_bwd_filter_kernel<kLinear, 4, kBF16>, grid,
               kFThreads, smem, p, st)
      : launch(cconv_klist_bwd_filter_kernel<kLinear, 8, kBF16>, grid,
               kFThreads, smem, p, st);
}

bool valid_interp(int interp) {
  return interp >= klist::kLinear && interp <= klist::kNearest;
}

}  // namespace

// Plain C entry points for ctypes.  Shapes as the forward's
// (cconv_klist_launch) plus dout [Q, Cout]; all contiguous, idx int32, the
// rest fp32 but, with bf16 != 0 (the bf16 variant, qfeats null), feats and
// w bf16; interp the interpolation (0 linear, 1 linear_border, 2
// nearest_neighbor).  Requires kz*ky*kx <= 1024, kz*ky*kx*Cin <= 8192,
// 1 <= Cout <= 256, K, N >= 1.  Each returns the CUDA error code of its
// launches (0 on success).
//
// Data: bytes of the workspace the launch below needs, or -1 for a shape
// it does not take (or Q*K past INT_MAX).
extern "C" long long cconv_klist_bwd_data_workspace(int Q, int K, int N,
                                                    int Cin, int Cout,
                                                    int kz, int ky, int kx,
                                                    int bf16) {
  Params p{};
  if (!data_plan(p, Q, K, N, Cin, Cout, kz, ky, kx)) return -1;
  return static_cast<long long>(data_work_bytes(p, bf16));
}

// Data: dfeats [N, Cin], dqfeats [Q, Cin] (null unless qfeats is given),
// da [Q, K] and dt [Q, K, 3] are written, and the transposed list: offsets
// [N + 1] (int32), and order [Q*K] (int32) whose first offsets[N] entries
// are the ids q*K + k of the slots with a != 0 by the row they read (idx
// clamped into [0, N)), row r's in ascending order at order[offsets[r] ..
// offsets[r + 1]); the rest of order is undefined.  work holds
// cconv_klist_bwd_data_workspace's bytes, undefined on entry and exit.
// Launches: a memset of the rows' counters, dT (which counts the rows'
// slots; its last block scans the counts into offsets), the query side
// (which files each slot into its row's run), the source side (which sorts
// each run, then sums); with Q 0 a memset of offsets and the source side.
extern "C" int cconv_klist_bwd_data_launch(
    const int* idx, const float* a, const float* t, const void* feats,
    const float* qfeats, const void* w, const float* dout, int* order,
    int* offsets, void* work, float* dfeats, float* dqfeats, float* da,
    float* dt, int Q, int K, int N, int Cin, int Cout, int kz, int ky,
    int kx, int bf16, int interp, void* stream) {
  Params p{};
  if (!data_plan(p, Q, K, N, Cin, Cout, kz, ky, kx) || !valid_interp(interp))
    return static_cast<int>(cudaErrorInvalidValue);
  p.interp = interp;
  if ((qfeats == nullptr) != (dqfeats == nullptr) ||
      (bf16 && qfeats != nullptr) || order == nullptr ||
      offsets == nullptr || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  char* wb = static_cast<char*>(work);
  p.idx = idx;
  p.a = a;
  p.t = t;
  p.qfeats = qfeats;
  p.dout = dout;
  p.order = order;
  p.offsets = offsets;
  p.ctr = reinterpret_cast<int*>(wb + ctr_at(p, bf16));
  p.dfeats = dfeats;
  p.dqfeats = dqfeats;
  p.da = da;
  p.dt = dt;
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  p.wpair = (Cout & 1) == 0 && (wa & (bf16 ? 3 : 7)) == 0;
  const uintptr_t fa = reinterpret_cast<uintptr_t>(feats)
      | reinterpret_cast<uintptr_t>(qfeats)
      | reinterpret_cast<uintptr_t>(work);
  p.vec4 = (Cin & 3) == 0 && (fa & (bf16 ? 7 : 15)) == 0;
  if (bf16) {
    p.feats_h = static_cast<const uint16_t*>(feats);
    p.w_h = static_cast<const uint16_t*>(w);
    p.work_h = reinterpret_cast<uint16_t*>(wb);
  } else {
    p.feats = static_cast<const float*>(feats);
    p.w = static_cast<const float*>(w);
    p.work = reinterpret_cast<float*>(wb);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (Q > 0) {
    err = static_cast<int>(cudaMemsetAsync(
        p.ctr, 0, sizeof(int) * (static_cast<size_t>(N) + 1), st));
    if (err != 0) return err;
    const dim3 tiles((Q + kDQ - 1) / kDQ, ((p.SC + 15) / 16 + p.MBC - 1)
                     / p.MBC);
    err = bf16 ? launch(cconv_klist_bwd_dT_kernel<true>, tiles, kDThreads,
                        dT_smem(p), p, st)
               : launch(cconv_klist_bwd_dT_kernel<false>, tiles, kDThreads,
                        dT_smem(p), p, st);
    if (err != 0) return err;
    const long long slots = static_cast<long long>(Q) * K;
    const dim3 walk(static_cast<unsigned>(
        (slots + kDThreads - 1) / kDThreads
        + (qfeats != nullptr ? (Q + kDWarps - 1) / kDWarps : 0)));
    err = bf16 ? launch(cconv_klist_bwd_walk_kernel<true>, walk, kDThreads,
                        walk_smem(p), p, st)
               : launch(cconv_klist_bwd_walk_kernel<false>, walk, kDThreads,
                        walk_smem(p), p, st);
    if (err != 0) return err;
  } else {
    err = static_cast<int>(cudaMemsetAsync(
        offsets, 0, sizeof(int) * (static_cast<size_t>(N) + 1), st));
    if (err != 0) return err;
  }
  const dim3 rows((N + kDWarps - 1) / kDWarps);
  return bf16 ? launch(cconv_klist_bwd_dfeats_kernel<true>, rows, kDThreads,
                       dfeats_smem(p), p, st)
              : launch(cconv_klist_bwd_dfeats_kernel<false>, rows, kDThreads,
                       dfeats_smem(p), p, st);
}

// Filter: floats of the workspace the launch below needs for this shape (0:
// none), or -1 for a shape it does not take.
extern "C" long long cconv_klist_bwd_filter_workspace(int Q, int K, int N,
                                                      int Cin, int Cout,
                                                      int kz, int ky,
                                                      int kx) {
  FParams p{};
  if (!filter_plan(p, Q, K, N, Cin, Cout, kz, ky, kx, klist::kLinear))
    return -1;
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
    int interp, void* stream) {
  if (Q <= 0) return 0;
  FParams p{};
  if (!valid_interp(interp) ||
      !filter_plan(p, Q, K, N, Cin, Cout, kz, ky, kx, interp) ||
      (bf16 && qfeats) || (p.G > 1 && work == nullptr))
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
  const int err = bf16 ? launch_filter<true>(p, interp, grid, smem, st)
                       : launch_filter<false>(p, interp, grid, smem, st);
  if (err != 0 || p.G == 1) return err;
  const size_t n = static_cast<size_t>(p.S) * Cin * Cout;
  const int blocks = static_cast<int>(
      std::min(static_cast<size_t>(8 * kFBlocks), (n + 127) / 128));
  cconv_klist_bwd_filter_sum_kernel<<<blocks, 128, 0, st>>>(work, dw, p.G,
                                                            n);
  return static_cast<int>(cudaGetLastError());
}
