// K-list continuous convolution for Hopper (sm_90a), fp32 results, in two
// variants: fp32 throughout, and bf16 (the JAX package's default
// precision).
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
// with the per-axis hat weights relu(1 - |clamp(t, -h, h) - (i - h)|),
// h = (size-1)/2, on the *centred* filter coordinates t (the ball->cube
// mapping is done outside, as the Pallas kernel also leaves it outside),
// idx clamped into [0, N): an index past the end reads row N-1, as JAX's
// clamped gather does; a negative one reads row 0, a safety clamp of the
// port only (JAX wraps it to idx + N first; the model makes none).
//
// What bounds it on the H100 (WaterRamps trunk conv, Q 2688, K 40, S 64,
// Cin 32, Cout 32): ~3 MB of inputs and output (~1 us of HBM).  The work
// the data needs is ~1.5 % of the dense tap tensor (a clamped linear hat
// has at most 2 non-zero weights per axis: 4 of the 64 taps of a [1,8,8]
// kernel) and a filter product over the ~55 % of T's rows a tap touches.
// Done that sparsely the work is a few us of the card's peak rates, so
// what bounds the kernel is instruction issue and latency: the dependent
// idx -> feats gather, the walk over each query's slots, the products'
// operand traffic.
//
// What the design does about it:
// - A block of 16 warps owns a tile of 16 queries (the m16 rows of
//   mma.sync), one warp a query, with no block barrier in the slot loop.
//   Lanes load 32 slots' idx/a/t coalesced, one group ahead of the group
//   being accumulated; each lane lists its own slot's non-zero taps in the
//   warp's scratch; then the warp walks the non-empty slots in order, with
//   the feature-row gathers of up to 8 slots in flight before any of them
//   is accumulated.
// - Only non-zero taps: per axis the taps i0 = floor(clamp(t) + h) (the
//   exact floor, from a round-down add) and i0 + 1.  Their weights come
//   from the same expression and product order as the plain twin's dense
//   taps, so each tap is bitwise equal to the twin's and the ASCC mirror
//   property holds.  Every T element has one writer lane and the slots are
//   walked in order: no float atomics, and two launches give equal bits.
// - Filter product over the 8-deep k-steps whose tap rows some query of
//   the tile touched (a row no tap touched is zero in T), split across the
//   warps along k and summed in a fixed order.  Non-symmetric convs use
//   the tensor cores, mma.sync.m16n8k8 TF32 with the 3xTF32 split
//   (big*big + big*small + small*big, each k-step's products added to the
//   fp32 sum with an IEEE add); W's fragments come from L2, 4 k-steps'
//   loads ahead of their products, once per 16 queries.  The symmetric
//   (ASCC) conv keeps a plain fp32 FMA product, its momentum path running
//   with TF32 off in the reference; each W row is read once per tile.
// - Shapes whose T tile exceeds the shared-memory budget are built and
//   contracted in chunks of tap rows (or of channels, for a single tap row
//   wider than the budget), re-walking the slots for each chunk.
//
// The bf16 variant (template flag kBF16, no symmetric form) computes JAX's
// fast_bf16 contraction (dmcf_tpu/ops/cconv.py:continuous_conv at
// precision "default", :241, :279-312): features and W arrive as bf16
// tensors (the gather moves half the bytes); each tap weight comes from
// the same fp32 expression and is rounded once to bf16; T's elements are
// summed in fp32 (the products of two bf16 values are exact) and rounded
// once to bf16 when the filter product loads them; the product is
// mma.sync.m16n8k16 bf16 x bf16 -> fp32 over 16-deep k-steps (one MMA where
// 3xTF32 takes three, at twice the TF32 rate), each k-step's result joining
// the fp32 sum with an IEEE add; the output is fp32.
//
// Interpolation (template parameter kMode, klist_taps.cuh): the hats above
// are "linear", JAX's default.  "linear_border" drops the clamp (a slot
// outside the span keeps the hats that reach into it, or none), and
// "nearest_neighbor" gives each axis one tap of weight 1 at
// clamp(round(t + h), 0, n - 1), a round-to-nearest add then round half to
// even, as jnp.round(t + h): a slot has one tap, so the walk's tap lists
// are one entry deep (kTaps 1).  Both variants take every mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "klist_taps.cuh"

namespace {

using klist::build_T;
using klist::mma_tf32;
using klist::row_set;
using klist::split;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kQB = kWarps;             // queries per block: mma rows
constexpr int kUB = 4;                  // k-steps whose W loads are in flight
constexpr int kNTW = 4;                 // n-tiles of 8 outputs a warp owns
constexpr int kOT = 2;                  // outputs per FMA-product pass
constexpr int kChunkMax = 2048;         // T elements per query in one chunk
constexpr int kFP = kChunkMax / kThreads;  // T columns a lane takes (FMA)

struct Params : klist::KListIn {
  const float* w;
  const uint16_t* w_h;          // bf16 variant
  float* out;
  int Cout;
  int RC, CW, ncc, nchunks;  // chunking: RC tap rows x CW channels
  int LD;                    // T row stride (floats)
  int NT, NG, KS;            // n-tiles of 8, warps along n, warps along k
  int MW;                    // tap-row mask words
  int taps;                  // most non-zero taps a slot can have (1, 4, 8)
};

struct SharedLayout {
  float* T;         // [kQB][LD]; the mma partials [KS][kQB][NT*8] at the end
  float* acc;       // [kQB][Cout] (symmetric)
  float* part;      // [kWarps][kQB][kOT] (symmetric)
  int2* taps;       // [kWarps][32 slots][taps] (row, weight bits)
  unsigned* tmask;  // [MW] tap rows some query of the tile touched
  int* steps;       // [kChunkMax / 8 + 1] touched k-steps, their count
};

__host__ __device__ inline size_t t_region(const Params& p) {
  const size_t t = static_cast<size_t>(kQB) * p.LD;
  const size_t red = static_cast<size_t>(p.KS) * kQB * p.NT * 8;
  return t > red ? t : red;
}

__host__ __device__ inline size_t sym_region(const Params& p, bool sym) {
  return sym ? static_cast<size_t>(kQB) * p.Cout + kWarps * kQB * kOT : 0;
}

__host__ __device__ inline size_t smem_bytes(const Params& p, bool sym) {
  return 4 * (t_region(p) + sym_region(p, sym)) +
         8 * static_cast<size_t>(kWarps) * 32 * p.taps +
         4 * (static_cast<size_t>(p.MW) + kChunkMax / 8 + 1);
}

__device__ __forceinline__ SharedLayout carve(float* smem, const Params& p,
                                              bool sym) {
  SharedLayout l;
  l.T = smem;
  l.acc = smem + t_region(p);
  l.part = l.acc + kQB * p.Cout;
  l.taps = reinterpret_cast<int2*>(smem + t_region(p) + sym_region(p, sym));
  l.tmask = reinterpret_cast<unsigned*>(l.taps + kWarps * 32 * p.taps);
  l.steps = reinterpret_cast<int*>(l.tmask + p.MW);
  return l;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two fp32 values rounded to bf16 and packed (lo in the low half), as an
// mma operand register holds two consecutive k elements.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Warp 0 lists the kStep-deep k-steps of the chunk's ce T columns whose
// tap rows some query of the tile touched; returns their count.
template <int kStep>
__device__ int list_steps(const SharedLayout& sh, int ce, int cw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nks = (ce + kStep - 1) / kStep;
  if (warp == 0) {
    int cnt = 0;
    for (int b = 0; b < nks; b += 32) {
      const int ks = b + lane;
      bool on = false;
      if (ks < nks) {
        const int r1 = min(ks * kStep + kStep - 1, ce - 1) / cw;
        for (int r = ks * kStep / cw; r <= r1 && !on; ++r)
          on = row_set(sh.tmask, r);
      }
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      if (on) sh.steps[cnt + __popc(bal & ((1u << lane) - 1))] = ks;
      cnt += __popc(bal);
    }
    if (lane == 0) sh.steps[kChunkMax / 8] = cnt;
  }
  __syncthreads();
  return sh.steps[kChunkMax / 8];
}

// out tile += T_chunk @ W_chunk on the tensor cores (3xTF32).  The 8-deep
// k-steps that some query of the tile touched are listed first.  Warp w
// then owns the n-tiles ng * kNTW .. + kNTW - 1 (acc[j]), ng = w mod NG, and
// every KS-th listed k-step from kp = w / NG: each A fragment is loaded and
// split once for all its n-tiles.  W fragments come straight from L2,
// kUB k-steps' loads ahead of their products, with no block barrier.
__device__ void contract_mma(const Params& p, const SharedLayout& sh,
                             int nr, int cw, size_t base,
                             float (*acc)[4]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ce = nr * cw;
  const int cnt = list_steps<8>(sh, ce, cw);
  const int kp = warp / p.NG;
  if (kp >= p.KS) return;
  const int nt0 = (warp - kp * p.NG) * kNTW;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const float* Tg = sh.T + g * p.LD + tq;
  for (int i0 = kp; i0 < cnt; i0 += kUB * p.KS) {
    float av[kUB][4], bv[kUB][kNTW][2];
#pragma unroll
    for (int u = 0; u < kUB; ++u) {  // every load of the batch first
      const int i = i0 + u * p.KS;
      const int k = i < cnt ? sh.steps[i] * 8 : 0;
      av[u][0] = Tg[k];
      av[u][1] = Tg[8 * p.LD + k];
      av[u][2] = Tg[k + 4];
      av[u][3] = Tg[8 * p.LD + k + 4];
      const float* wr = p.w + (base + k + tq) * p.Cout + nt0 * 8 + g;
      const bool r0 = i < cnt && k + tq < ce;
      const bool r1 = i < cnt && k + tq + 4 < ce;
#pragma unroll
      for (int j = 0; j < kNTW; ++j) {
        const bool col = (nt0 + j) * 8 + g < p.Cout;
        bv[u][j][0] = r0 && col ? __ldg(wr + 8 * j) : 0.0f;
        bv[u][j][1] = r1 && col ? __ldg(wr + 4 * p.Cout + 8 * j) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUB; ++u) {
      if (i0 + u * p.KS >= cnt) break;
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(av[u][e], ab[e], as[e]);
#pragma unroll
      for (int j = 0; j < kNTW; ++j) {
        if (nt0 + j >= p.NT) break;
        uint32_t bb[2], bs[2];
        split(bv[u][j][0], bb[0], bs[0]);
        split(bv[u][j][1], bb[1], bs[1]);
        // the tensor core's adder keeps fewer bits than an fp32 add: each
        // k-step's 3 products start from 0 and join the running sum with
        // an IEEE add, so a deep product errs as fp32 does
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(c, as, bb);
        mma_tf32(c, ab, bs);
        mma_tf32(c, ab, bb);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += c[e];
      }
    }
  }
}

// out tile += bf16(T_chunk) @ W16_chunk on the tensor cores: as
// contract_mma over 16-deep k-steps, one bf16 MMA a k-step and n-tile.  T
// is rounded to bf16 as its fragments are packed; W's bf16 pairs come
// straight from L2.  A row past the chunk's ce columns is zero in T and
// masked in W.
__device__ void contract_mma_bf16(const Params& p, const SharedLayout& sh,
                                  int nr, int cw, size_t base,
                                  float (*acc)[4]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ce = nr * cw;
  const int cnt = list_steps<16>(sh, ce, cw);
  const int kp = warp / p.NG;
  if (kp >= p.KS) return;
  const int nt0 = (warp - kp * p.NG) * kNTW;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const float* Tg = sh.T + g * p.LD + 2 * tq;
  for (int i0 = kp; i0 < cnt; i0 += kUB * p.KS) {
    uint32_t av[kUB][4], bv[kUB][kNTW][2];
#pragma unroll
    for (int u = 0; u < kUB; ++u) {  // every load of the batch first
      const int i = i0 + u * p.KS;
      const int k = i < cnt ? sh.steps[i] * 16 : 0;
      const float2 x0 = *reinterpret_cast<const float2*>(Tg + k);
      const float2 x1 = *reinterpret_cast<const float2*>(Tg + 8 * p.LD + k);
      const float2 x2 = *reinterpret_cast<const float2*>(Tg + k + 8);
      const float2 x3 =
          *reinterpret_cast<const float2*>(Tg + 8 * p.LD + k + 8);
      av[u][0] = pack_bf16(x0.x, x0.y);
      av[u][1] = pack_bf16(x1.x, x1.y);
      av[u][2] = pack_bf16(x2.x, x2.y);
      av[u][3] = pack_bf16(x3.x, x3.y);
      const int r = k + 2 * tq;  // this lane's B rows r, r+1, r+8, r+9
      const uint16_t* wr = p.w_h + (base + r) * p.Cout + nt0 * 8 + g;
      const bool live = i < cnt;
#pragma unroll
      for (int j = 0; j < kNTW; ++j) {
        const bool col = live && (nt0 + j) * 8 + g < p.Cout;
        const uint32_t w0 = col && r < ce ? __ldg(wr + 8 * j) : 0u;
        const uint32_t w1 =
            col && r + 1 < ce ? __ldg(wr + p.Cout + 8 * j) : 0u;
        const uint32_t w8 =
            col && r + 8 < ce ? __ldg(wr + 8 * p.Cout + 8 * j) : 0u;
        const uint32_t w9 =
            col && r + 9 < ce ? __ldg(wr + 9 * p.Cout + 8 * j) : 0u;
        bv[u][j][0] = w0 | (w1 << 16);
        bv[u][j][1] = w8 | (w9 << 16);
      }
    }
#pragma unroll
    for (int u = 0; u < kUB; ++u) {
      if (i0 + u * p.KS >= cnt) break;
#pragma unroll
      for (int j = 0; j < kNTW; ++j) {
        if (nt0 + j >= p.NT) break;
        // each k-step's product starts from 0 and joins the running sum
        // with an IEEE add, as in contract_mma
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(c, av[u], bv[u][j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += c[e];
      }
    }
  }
}

// acc[q, :] += T_chunk[q] @ W_chunk in fp32 FMAs, kOT outputs a pass.
// Lane l of warp w takes the T columns w * 32 + l + m * kThreads whose tap
// row a query of the tile touched, reads their W row once for all 16
// queries, and the warps' partial sums are added in a fixed order.
__device__ void contract_fma(const Params& p, const SharedLayout& sh,
                             int nr, int cw, size_t base) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ce = nr * cw;
  for (int o0 = 0; o0 < p.Cout; o0 += kOT) {
    float wv[kFP][kOT];
    int col[kFP];
#pragma unroll
    for (int m = 0; m < kFP; ++m) {  // the W loads first
      const int kk = warp * 32 + lane + m * kThreads;
      col[m] = kk < ce && row_set(sh.tmask, kk / cw) ? kk : -1;
#pragma unroll
      for (int o = 0; o < kOT; ++o)
        wv[m][o] = col[m] >= 0 && o0 + o < p.Cout
            ? __ldg(p.w + (base + kk) * p.Cout + o0 + o) : 0.0f;
    }
    float y[kQB][kOT];
#pragma unroll
    for (int qi = 0; qi < kQB; ++qi)
#pragma unroll
      for (int o = 0; o < kOT; ++o) y[qi][o] = 0.0f;
#pragma unroll
    for (int m = 0; m < kFP; ++m) {
      if (!__any_sync(0xffffffffu, col[m] >= 0)) continue;
#pragma unroll
      for (int qi = 0; qi < kQB; ++qi) {
        const float tv = col[m] >= 0 ? sh.T[qi * p.LD + col[m]] : 0.0f;
#pragma unroll
        for (int o = 0; o < kOT; ++o) y[qi][o] = fmaf(tv, wv[m][o], y[qi][o]);
      }
    }
#pragma unroll
    for (int qi = 0; qi < kQB; ++qi)
#pragma unroll
      for (int o = 0; o < kOT; ++o) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          y[qi][o] += __shfl_xor_sync(0xffffffffu, y[qi][o], off);
        if (lane == 0) sh.part[(warp * kQB + qi) * kOT + o] = y[qi][o];
      }
    __syncthreads();
    if (threadIdx.x < kQB * kOT) {
      const int qi = threadIdx.x / kOT;
      const int o = threadIdx.x - qi * kOT;
      if (o0 + o < p.Cout) {
        float s = 0.0f;
        for (int w = 0; w < kWarps; ++w)
          s += sh.part[(w * kQB + qi) * kOT + o];
        sh.acc[qi * p.Cout + o0 + o] += s;
      }
    }
    __syncthreads();
  }
}

template <bool kSym, int kMode, int kTaps, bool kBF16>
__global__ void __launch_bounds__(kThreads)
cconv_klist_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const SharedLayout sh = carve(reinterpret_cast<float*>(smem4), p, kSym);
  const int q0 = blockIdx.x * kQB;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float acc[kNTW][4];
#pragma unroll
  for (int j = 0; j < kNTW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  if (kSym)
    for (int i = tid; i < kQB * p.Cout; i += kThreads) sh.acc[i] = 0.0f;

  for (int ch = 0; ch < p.nchunks; ++ch) {
    const int rc = ch / p.ncc;
    const int s0 = rc * p.RC;
    const int nr = min(p.S, s0 + p.RC) - s0;
    const int clo = (ch - rc * p.ncc) * p.CW;
    const int cw = min(p.Cin, clo + p.CW) - clo;
    const size_t base = static_cast<size_t>(s0) * p.Cin + clo;
    float4* T4 = reinterpret_cast<float4*>(sh.T);
    for (int i = tid; i < kQB * p.LD / 4; i += kThreads)
      T4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < p.MW; i += kThreads) sh.tmask[i] = 0u;
    __syncthreads();
    build_T<kMode, kTaps, kBF16>(p, sh.T, p.LD, sh.taps, sh.tmask, q0, s0,
                                 nr, clo, cw);
    __syncthreads();
    if (kSym)
      contract_fma(p, sh, nr, cw, base);
    else if (kBF16)
      contract_mma_bf16(p, sh, nr, cw, base, acc);
    else
      contract_mma(p, sh, nr, cw, base, acc);
    __syncthreads();
  }

  if (kSym) {
    for (int i = tid; i < kQB * p.Cout; i += kThreads) {
      const int qi = i / p.Cout;
      if (q0 + qi < p.Q)
        p.out[static_cast<size_t>(q0) * p.Cout + i] = sh.acc[i];
    }
    return;
  }
  // mma partials of the k-split -> T's space, summed in a fixed order
  const int np = p.NT * 8;
  const int kp = warp / p.NG;
  if (kp < p.KS) {
    const int nt0 = (warp - kp * p.NG) * kNTW;
    const int g = lane >> 2;
    const int tq = lane & 3;
    float* red = sh.T + kp * kQB * np;
#pragma unroll
    for (int j = 0; j < kNTW; ++j) {
      const int n = (nt0 + j) * 8 + 2 * tq;
      if (nt0 + j < p.NT) {
        red[g * np + n] = acc[j][0];
        red[g * np + n + 1] = acc[j][1];
        red[(g + 8) * np + n] = acc[j][2];
        red[(g + 8) * np + n + 1] = acc[j][3];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kQB * p.Cout; i += kThreads) {
    const int qi = i / p.Cout;
    const int o = i - qi * p.Cout;
    if (q0 + qi < p.Q) {
      float s = sh.T[qi * np + o];
      for (int k = 1; k < p.KS; ++k) s += sh.T[(k * kQB + qi) * np + o];
      p.out[static_cast<size_t>(q0) * p.Cout + i] = s;
    }
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Chunking and tiling of one launch (shared by the launcher and the
// shared-memory report).
Params plan(int Q, int K, int N, int Cin, int Cout, int kz, int ky,
            int kx, bool bf16, int interp) {
  Params p{};
  p.Q = Q;
  p.K = K;
  p.N = N;
  p.Cin = Cin;
  p.Cout = Cout;
  p.kz = kz;
  p.ky = ky;
  p.kx = kx;
  p.S = kz * ky * kx;
  if (Cin <= kChunkMax) {
    p.RC = kChunkMax / Cin < p.S ? kChunkMax / Cin : p.S;
    p.CW = Cin;
    p.ncc = 1;
  } else {  // one tap row is wider than the budget: chunks of channels
    p.RC = 1;
    p.CW = kChunkMax;
    p.ncc = (Cin + kChunkMax - 1) / kChunkMax;
  }
  p.nchunks = (p.S + p.RC - 1) / p.RC * p.ncc;
  // +4: conflict-free TF32 A fragments; +8 for the bf16 variant's float2
  // fragment loads
  p.LD = round_up(p.RC * p.CW, 32) + (bf16 ? 8 : 4);
  p.NT = (Cout + 7) / 8;
  p.NG = (p.NT + kNTW - 1) / kNTW;
  p.KS = kWarps / p.NG;
  p.MW = (p.RC + 31) / 32;
  p.taps = klist::max_taps(interp, kz, ky, kx);
  return p;
}

template <bool kSym, int kMode, int kTaps, bool kBF16>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p, kSym);
  auto kernel = cconv_klist_kernel<kSym, kMode, kTaps, kBF16>;
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(p.Q + kQB - 1) / kQB, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of the mode and the plan's tap count.
template <bool kSym, bool kBF16>
int launch_mode(const Params& p, int interp, cudaStream_t stream) {
  using klist::kLinear;
  using klist::kLinearBorder;
  using klist::kNearest;
  if (interp == kNearest) return launch<kSym, kNearest, 1, kBF16>(p, stream);
  if (interp == kLinearBorder)
    return p.taps == 4 ? launch<kSym, kLinearBorder, 4, kBF16>(p, stream)
                       : launch<kSym, kLinearBorder, 8, kBF16>(p, stream);
  return p.taps == 4 ? launch<kSym, kLinear, 4, kBF16>(p, stream)
                     : launch<kSym, kLinear, 8, kBF16>(p, stream);
}

}  // namespace

// Plain C entry point for ctypes.  Shapes: idx/a [Q,K], t [Q,K,3] (tz,ty,tx),
// feats [N,Cin], qfeats [Q,Cin] or null (the symmetric conv), w
// [kz*ky*kx*Cin, Cout], out [Q,Cout]; all contiguous, idx int32 (clamped
// into [0, N) here), the rest fp32 but, with bf16 != 0 (the bf16 variant,
// qfeats null), feats and w bf16; interp the interpolation (0 linear, 1
// linear_border, 2 nearest_neighbor).  Requires kz*ky*kx <= 1024,
// kz*ky*kx*Cin <= 8192, 1 <= Cout <= 256, K >= 1 and N >= 1.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int cconv_klist_launch(const int* idx, const float* a,
                                  const float* t, const void* feats,
                                  const float* qfeats, const void* w,
                                  float* out, int Q, int K, int N, int Cin,
                                  int Cout, int kz, int ky, int kx, int bf16,
                                  int interp, void* stream) {
  const int S = kz * ky * kx;
  if (Q <= 0) return 0;
  if (K <= 0 || N <= 0 || Cin <= 0 || Cout <= 0 || Cout > 256 || kz <= 0 ||
      ky <= 0 || kx <= 0 || S > 1024 || S * Cin > 8192 ||
      (bf16 && qfeats != nullptr) || interp < klist::kLinear ||
      interp > klist::kNearest)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = plan(Q, K, N, Cin, Cout, kz, ky, kx, bf16 != 0, interp);
  p.idx = idx;
  p.a = a;
  p.t = t;
  p.qfeats = qfeats;
  p.out = out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    p.feats_h = static_cast<const uint16_t*>(feats);
    p.w_h = static_cast<const uint16_t*>(w);
    return launch_mode<false, true>(p, interp, st);
  }
  p.feats = static_cast<const float*>(feats);
  p.w = static_cast<const float*>(w);
  if (qfeats != nullptr) return launch_mode<true, false>(p, interp, st);
  return launch_mode<false, false>(p, interp, st);
}

// Dynamic shared memory (bytes) one block of the launch above takes (the
// linear hats'; a nearest launch's tap lists are a quarter or an eighth).
extern "C" int cconv_klist_smem_bytes(int Cin, int Cout, int kz, int ky,
                                      int kx, int symmetric, int bf16) {
  const Params p = plan(1, 1, 1, Cin, Cout, kz, ky, kx, bf16 != 0,
                        klist::kLinear);
  return static_cast<int>(smem_bytes(p, symmetric != 0));
}
