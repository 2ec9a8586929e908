// K-list continuous convolution for Hopper (sm_90a), fp32 results.
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

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kQB = kWarps;             // queries per block: mma rows
constexpr int kU = 8;                   // slots whose gathers are in flight
constexpr int kUB = 4;                  // k-steps whose W loads are in flight
constexpr int kNTW = 4;                 // n-tiles of 8 outputs a warp owns
constexpr int kOT = 2;                  // outputs per FMA-product pass
constexpr int kChunkMax = 2048;         // T elements per query in one chunk
constexpr int kFP = kChunkMax / kThreads;  // T columns a lane takes (FMA)
constexpr int kMaxWords = 32;           // tap-row mask words (S <= 1024)

struct Params {
  const int* idx;
  const float* a;
  const float* t;
  const float* feats;
  const float* qfeats;
  const float* w;
  float* out;
  int Q, K, N, Cin, Cout, kz, ky, kx, S;
  int RC, CW, ncc, nchunks;  // chunking: RC tap rows x CW channels
  int LD;                    // T row stride (floats)
  int NT, NG, KS;            // n-tiles of 8, warps along n, warps along k
  int MW;                    // tap-row mask words
  int taps;                  // most non-zero taps a slot can have (4 or 8)
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

__device__ __forceinline__ bool row_set(const unsigned* m, int r) {
  return (m[r >> 5] >> (r & 31)) & 1u;
}

__device__ __forceinline__ float hat(float tc, float half, int i) {
  return fmaxf(1.0f - fabsf(tc - (static_cast<float>(i) - half)), 0.0f);
}

// The <= 2 non-zero hats of one axis: taps i0 and i0 + 1 (cnt of them in
// range).  __fadd_rd makes floor() the exact floor of tc + half, so no
// non-zero hat lies outside the pair (a round-to-nearest add can round
// tc + half up to the next integer and miss a 2^-24 hat below it).
struct Axis {
  int i0, cnt;
  float w0, w1;
};

__device__ __forceinline__ Axis axis_taps(float t, int n) {
  const float half = 0.5f * (n - 1);
  const float tc = fminf(fmaxf(t, -half), half);
  Axis r;
  r.i0 = min(static_cast<int>(floorf(__fadd_rd(tc, half))), n - 1);
  r.cnt = r.i0 + 1 < n ? 2 : 1;
  r.w0 = hat(tc, half, r.i0);
  r.w1 = r.cnt == 2 ? hat(tc, half, r.i0 + 1) : 0.0f;
  return r;
}

struct Slots {  // one lane's slot of a 32-slot group
  int idx;
  float a, tz, ty, tx;
};

__device__ __forceinline__ Slots load_group(const Params& p, int q, int k) {
  Slots s{0, 0.0f, 0.0f, 0.0f, 0.0f};
  if (q < p.Q && k < p.K) {
    const size_t e = static_cast<size_t>(q) * p.K + k;
    s.idx = p.idx[e];
    s.a = p.a[e];
    s.tz = p.t[3 * e];
    s.ty = p.t[3 * e + 1];
    s.tx = p.t[3 * e + 2];
  }
  return s;
}

// This lane's slot -> its non-zero taps inside the chunk's tap rows
// [s0, s0 + nr): (row relative to s0, weight bits) in tp.  Returns the
// count, <= kTaps (kTaps = 4 when an axis of the kernel has size 1).
template <int kTaps>
__device__ __forceinline__ int slot_taps(const Params& p, const Slots& sl,
                                         int s0, int nr, int2* tp) {
  if (sl.a == 0.0f) return 0;
  const Axis z = axis_taps(sl.tz, p.kz);
  const Axis y = axis_taps(sl.ty, p.ky);
  const Axis x = axis_taps(sl.tx, p.kx);
  int n = 0;
#pragma unroll
  for (int jz = 0; jz < 2; ++jz)
#pragma unroll
    for (int jy = 0; jy < 2; ++jy)
#pragma unroll
      for (int jx = 0; jx < 2; ++jx) {
        if (jz >= z.cnt || jy >= y.cnt || jx >= x.cnt) continue;
        const float wz = jz ? z.w1 : z.w0;
        const float wy = jy ? y.w1 : y.w0;
        const float wx = jx ? x.w1 : x.w0;
        const float wt = ((wz * wy) * wx) * sl.a;  // the twin's order
        const int r = ((z.i0 + jz) * p.ky + y.i0 + jy) * p.kx + x.i0 + jx
            - s0;
        if (wt != 0.0f && r >= 0 && r < nr)
          tp[n++] = make_int2(r, __float_as_int(wt));
      }
  return n;
}

// Accumulate this chunk's T rows (tap rows [s0, s0 + nr), channels
// [clo, clo + cw)) of the warp's query, and mark the touched rows in the
// tile's mask.  Lane (j0, c0) owns T's elements (r, c) with c = c0 modulo
// CPL (the channels' power of two, at most 32) and r = j0 modulo 32 / CPL:
// every element has one writer, so the slots need no barrier between them
// and are summed in a fixed order.
template <int kTaps>
__device__ void build_T(const Params& p, const SharedLayout& sh, int q0,
                        int s0, int nr, int clo, int cw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int cpl = 1;
  while (cpl < p.Cin && cpl < 32) cpl <<= 1;
  const int rmask = 32 / cpl - 1;
  const int c0 = lane & (cpl - 1);
  const int j0 = lane / cpl;
  const int q = q0 + warp;
  float* Tq = sh.T + warp * p.LD;
  int2* tp = sh.taps + warp * 32 * kTaps;

  Slots cur = load_group(p, q, lane);
  for (int k0 = 0; k0 < p.K; k0 += 32) {
    Slots nxt{0, 0.0f, 0.0f, 0.0f, 0.0f};
    if (k0 + 32 < p.K)  // the next group's slots load under this one
      nxt = load_group(p, q, k0 + 32 + lane);
    const int ntap = slot_taps<kTaps>(p, cur, s0, nr, tp + lane * kTaps);
    // the group's tap rows into the tile's mask: one OR-reduction and one
    // atomic per mask word, not one atomic per tap
    int wlo = kMaxWords, whi = -1;
    for (int j = 0; j < ntap; ++j) {
      wlo = min(wlo, tp[lane * kTaps + j].x >> 5);
      whi = max(whi, tp[lane * kTaps + j].x >> 5);
    }
    wlo = __reduce_min_sync(0xffffffffu, wlo);
    whi = __reduce_max_sync(0xffffffffu, whi);
    for (int wd = wlo; wd <= whi; ++wd) {
      unsigned m = 0u;
      for (int j = 0; j < ntap; ++j) {
        const int r = tp[lane * kTaps + j].x;
        if ((r >> 5) == wd) m |= 1u << (r & 31);
      }
      m = __reduce_or_sync(0xffffffffu, m);
      if (lane == 0 && m != 0u) atomicOr(sh.tmask + wd, m);
    }
    __syncwarp();
    unsigned bits = __ballot_sync(0xffffffffu, ntap > 0);
    while (bits) {
      int src[kU];
      int n = 0;
#pragma unroll
      for (int i = 0; i < kU; ++i) {
        src[i] = 0;
        if (bits) {
          src[i] = __ffs(bits) - 1;
          bits &= bits - 1;
          n = i + 1;
        }
      }
      for (int cb = clo; cb < clo + cw; cb += cpl) {
        const int c = cb + c0;
        const bool cval = c < clo + cw;
        const float qv = (p.qfeats != nullptr && cval)
            ? p.qfeats[static_cast<size_t>(q) * p.Cin + c] : 0.0f;
        float g[kU];
#pragma unroll
        for (int i = 0; i < kU; ++i) {  // all gathers first
          const int id = __shfl_sync(0xffffffffu, cur.idx, src[i]);
          const int row = min(max(id, 0), p.N - 1);
          g[i] = (i < n && cval)
              ? p.feats[static_cast<size_t>(row) * p.Cin + c] + qv : 0.0f;
        }
        int nts[kU];
#pragma unroll
        for (int i = 0; i < kU; ++i)
          nts[i] = __shfl_sync(0xffffffffu, ntap, src[i]);
        // a slot's tap entries are read while the previous slot's T
        // elements are updated; only the T read-modify-write is serial
        int2 nxt_e[kTaps];
#pragma unroll
        for (int j = 0; j < kTaps; ++j)
          nxt_e[j] = j < nts[0] ? tp[src[0] * kTaps + j] : make_int2(-1, 0);
#pragma unroll
        for (int i = 0; i < kU; ++i) {
          if (i >= n) break;
          int2 e[kTaps];
#pragma unroll
          for (int j = 0; j < kTaps; ++j) e[j] = nxt_e[j];
          if (i + 1 < kU) {
#pragma unroll
            for (int j = 0; j < kTaps; ++j)
              nxt_e[j] = i + 1 < n && j < nts[i + 1]
                  ? tp[src[i + 1] * kTaps + j] : make_int2(-1, 0);
          }
          // a slot's taps are distinct rows: load them all, then store
          int off[kTaps];
          float tv[kTaps];
#pragma unroll
          for (int j = 0; j < kTaps; ++j) {
            off[j] = -1;
            if (e[j].x >= 0 && cval && (e[j].x & rmask) == j0) {
              off[j] = e[j].x * cw + (c - clo);
              tv[j] = Tq[off[j]];
            }
          }
#pragma unroll
          for (int j = 0; j < kTaps; ++j)
            if (off[j] >= 0)
              Tq[off[j]] = fmaf(__int_as_float(e[j].y), g[i], tv[j]);
        }
      }
    }
    __syncwarp();  // the next group rewrites the scratch
    cur = nxt;
  }
}

// x rounded to TF32 (10 mantissa bits), half away from zero: the bits of
// cvt.rna.tf32.f32, from two integer operations instead of a conversion
// (conversions issue at a quarter of the FP32 rate).  Finite x only.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 3xTF32 operands: x = big + small to ~2^-22 relative.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
  const int nks = (ce + 7) >> 3;
  if (warp == 0) {  // list the k-steps whose tap rows a query touched
    int cnt = 0;
    for (int b = 0; b < nks; b += 32) {
      const int ks = b + lane;
      bool on = false;
      if (ks < nks) {
        const int r1 = min(ks * 8 + 7, ce - 1) / cw;
        for (int r = ks * 8 / cw; r <= r1 && !on; ++r)
          on = row_set(sh.tmask, r);
      }
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      if (on) sh.steps[cnt + __popc(bal & ((1u << lane) - 1))] = ks;
      cnt += __popc(bal);
    }
    if (lane == 0) sh.steps[kChunkMax / 8] = cnt;
  }
  __syncthreads();
  const int cnt = sh.steps[kChunkMax / 8];
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

template <bool kSym, int kTaps>
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
    build_T<kTaps>(p, sh, q0, s0, nr, clo, cw);
    __syncthreads();
    if (kSym)
      contract_fma(p, sh, nr, cw, base);
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
            int kx) {
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
  p.LD = round_up(p.RC * p.CW, 32) + 4;  // +4: conflict-free A fragments
  p.NT = (Cout + 7) / 8;
  p.NG = (p.NT + kNTW - 1) / kNTW;
  p.KS = kWarps / p.NG;
  p.MW = (p.RC + 31) / 32;
  p.taps = kz == 1 || ky == 1 || kx == 1 ? 4 : 8;
  return p;
}

template <bool kSym, int kTaps>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p, kSym);
  auto kernel = cconv_klist_kernel<kSym, kTaps>;
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(p.Q + kQB - 1) / kQB, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  Shapes: idx/a [Q,K], t [Q,K,3] (tz,ty,tx),
// feats [N,Cin], qfeats [Q,Cin] or null (the symmetric conv), w
// [kz*ky*kx*Cin, Cout], out [Q,Cout]; all contiguous, idx int32 (clamped
// into [0, N) here), the rest fp32.  Requires kz*ky*kx <= 1024,
// kz*ky*kx*Cin <= 8192, 1 <= Cout <= 256, K >= 1 and N >= 1.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int cconv_klist_launch(const int* idx, const float* a,
                                  const float* t, const float* feats,
                                  const float* qfeats, const float* w,
                                  float* out, int Q, int K, int N, int Cin,
                                  int Cout, int kz, int ky, int kx,
                                  void* stream) {
  const int S = kz * ky * kx;
  if (Q <= 0) return 0;
  if (K <= 0 || N <= 0 || Cin <= 0 || Cout <= 0 || Cout > 256 || kz <= 0 ||
      ky <= 0 || kx <= 0 || S > 1024 || S * Cin > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = plan(Q, K, N, Cin, Cout, kz, ky, kx);
  p.idx = idx;
  p.a = a;
  p.t = t;
  p.feats = feats;
  p.qfeats = qfeats;
  p.w = w;
  p.out = out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qfeats != nullptr)
    return p.taps == 4 ? launch<true, 4>(p, st) : launch<true, 8>(p, st);
  return p.taps == 4 ? launch<false, 4>(p, st) : launch<false, 8>(p, st);
}

// Dynamic shared memory (bytes) one block of the launch above takes.
extern "C" int cconv_klist_smem_bytes(int Cin, int Cout, int kz, int ky,
                                      int kx, int symmetric) {
  const Params p = plan(1, 1, 1, Cin, Cout, kz, ky, kx);
  return static_cast<int>(smem_bytes(p, symmetric != 0));
}
