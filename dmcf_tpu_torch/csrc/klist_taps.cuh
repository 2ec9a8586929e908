// The K-list conv's tap walk, shared by the forward (csrc/cconv_klist.cu)
// and the filter gradient (csrc/cconv_klist_bwd.cu): both build the same
// T[q, s, c] = sum_k A[k, s] g[k, c] of a tile of 16 queries with this
// code, so the filter gradient contracts bitwise the forward's T.  Also the
// 3xTF32 helpers both use.  The design of the walk is in the forward's note.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace klist {

constexpr int kMaxWords = 32;  // tap-row mask words (S <= 1024)
constexpr int kU = 8;          // slots whose gathers are in flight

// The inputs the tap walk reads (the kernels' parameter blocks extend it).
struct KListIn {
  const int* idx;
  const float* a;
  const float* t;
  const float* feats;           // fp32 variant
  const float* qfeats;
  const uint16_t* feats_h;      // bf16 variant: the bits of bf16 values
  int Q, K, N, Cin, kz, ky, kx, S;
};

__device__ __forceinline__ bool row_set(const unsigned* m, int r) {
  return (m[r >> 5] >> (r & 31)) & 1u;
}

// bf16 bits -> fp32 (exact) and fp32 -> bf16 (round to nearest even)
__device__ __forceinline__ float bf16_val(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

__device__ __forceinline__ Slots load_group(const KListIn& p, int q, int k) {
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
// count, <= kTaps (kTaps = 4 when an axis of the kernel has size 1).  The
// bf16 variant rounds each weight to bf16 (a weight that rounds to 0 is
// dropped: it adds nothing).
template <int kTaps, bool kBF16>
__device__ __forceinline__ int slot_taps(const KListIn& p, const Slots& sl,
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
        float wt = ((wz * wy) * wx) * sl.a;  // the twin's order
        if (kBF16) wt = round_bf16(wt);
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
template <int kTaps, bool kBF16>
__device__ void build_T(const KListIn& p, float* T, int ld, int2* taps,
                        unsigned* tmask, int q0, int s0, int nr, int clo,
                        int cw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int cpl = 1;
  while (cpl < p.Cin && cpl < 32) cpl <<= 1;
  const int rmask = 32 / cpl - 1;
  const int c0 = lane & (cpl - 1);
  const int j0 = lane / cpl;
  const int q = q0 + warp;
  float* Tq = T + warp * ld;
  int2* tp = taps + warp * 32 * kTaps;

  Slots cur = load_group(p, q, lane);
  for (int k0 = 0; k0 < p.K; k0 += 32) {
    Slots nxt{0, 0.0f, 0.0f, 0.0f, 0.0f};
    if (k0 + 32 < p.K)  // the next group's slots load under this one
      nxt = load_group(p, q, k0 + 32 + lane);
    const int ntap = slot_taps<kTaps, kBF16>(p, cur, s0, nr,
                                             tp + lane * kTaps);
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
      if (lane == 0 && m != 0u) atomicOr(tmask + wd, m);
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
          const size_t e = static_cast<size_t>(min(max(id, 0), p.N - 1))
              * p.Cin + c;
          if (kBF16)
            g[i] = (i < n && cval) ? bf16_val(p.feats_h[e]) : 0.0f;
          else
            g[i] = (i < n && cval) ? p.feats[e] + qv : 0.0f;
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

}  // namespace klist
