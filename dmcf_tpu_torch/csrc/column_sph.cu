// SPH1D column solver for Hopper (sm_90a): the whole time integration of
// every scene of a split in one launch.
//
// Replaces dmcf_tpu/data/generators.py:_column_solve_jax, the JAX
// package's compiled solver (a lax.while_loop pressure projection inside a
// lax.scan over frames, run by XLA on the CPU; the repo has no TPU kernel
// for it).  Contract: dmcf_tpu_torch/kernels/column_sph.py.
//
// What bounds it: one projection iteration of the longest scene, on one
// SM.  A scene is at most 64 particles; a frame runs up to max_iter
// (10,000) projection iterations, each two all-pairs sums that depend on
// the previous iteration, and the projection almost never converges before
// max_iter.  So a split is about 10^6 dependent iterations: ~64 x 2 x 25
// fp32 operations an iteration against 67 TFLOP/s would take picoseconds,
// and the count of iterations is fixed by the semantics.  What an
// iteration costs is the issue of its instructions on the SM's four
// schedulers and the latency of its dependent chain (two 64-slot sums,
// five divisions, two barriers).  The kernel computes both arms of every
// spline and every pair, in or out of the support, and then selects; it
// counts the pairs that fall in each arm (``pairs``) so that a bound can
// count only the work the data needs.
//
// Design: one block a scene, a group of kRowLanes = 16 lanes a particle
// row (two rows a warp).  Lane g of a group forms the leaves of slots g,
// g + 16, g + 32 and g + 48 of its row's 64-slot pair sum, adds the pairs
// 32 apart and then 16 apart in the lane, and __shfl_xor_sync over 8, 4, 2
// and 1 finishes the sum (``group_tree``).  That is the fixed tree order
// of the plain version (kernels/column_sph.py ``tree_sum``: slot j with
// j + 32, then j + 16, ...): after the xor step over ``off`` lane g holds
// the partial of index g mod off, added in the other order where g has
// that bit set, and an IEEE add is commutative bit for bit.  So two
// launches give the same bits and the plain version gives the same bits
// too (tests/test_torch_column.py emulates the order for every group
// width).  Every elementwise operation is JAX's in fp32, written with the
// _rn intrinsics so that nvcc fuses no multiply-add; nanmax and clamp0
// keep a NaN as jnp.max and jnp.clip do; a division by a constant that is
// a power of two (mass 1 and rest density 2 in every shipped config) is a
// product with its exact inverse, which rounds the same real number.
//
// Layout: the block has ceil(P / 2) warps, at most 32.  A warp a row with
// 32 lanes (two rows a warp past P 32, the first layout of this kernel)
// spends a whole warp's issue slot on each row's scalar work (its
// pressure, five divisions, the updates, the shuffle levels); 16 lanes
// share those slots between two rows, and 8 lanes leave too few warps to
// hide the chain's latency.  Measured on an H100 (symnet.yml's train
// split, scripts/torch_redesign_variants.py): 16 lanes 1.56 us an
// iteration, 32 lanes 2.06, 8 lanes 1.87.  A block, not a cluster of two:
// one barrier of the block is cheaper than a cluster barrier, x and
// p/rho^2 stay in the block's own shared memory, and only 40, 10 and 3
// scenes run a split, so most SMs idle either way.  Rows at or past
// counts[s] run the sums with the rest of their warp (the shuffles need
// every lane) but move no particle, and what they write lies in slots the
// sums mask.  A projection iteration is then: the density sum, the row's
// pressure, p/rho^2, mass/rho and over-density (a boundary row's warp also
// sums the density of particle bcnt, whose pressure it takes, instead of
// waiting for it), one barrier, the pressure-gradient sum and the update,
// the new x into the other of two shared buffers (so no barrier stands
// between the sum that reads the old x and the write), the block max of
// err over the rows' over-densities (off the sums' path), and a second
// barrier.  A scene leaves its projection loop at err < eps or max_iter on
// its own (err is block-uniform); the first iteration always runs.  The
// pair counts are per-lane integers summed at the end of a frame (any
// order).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kSlots = 64;
constexpr int kMaxWarps = 32;

struct Consts {
  float mass, gravity, rest, stiff, visc, cw, soft, dt, dt2, eps;
  // 1 / mass and 1 / rest where that divisor is a power of two (a quotient
  // by 2^k and the product with 2^-k round the same real number: the same
  // bits), else 0
  float mass_inv, rest_inv;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}
// a / b for a constant divisor b, a product where b is a power of two
__device__ __forceinline__ float div_c(float a, float b, float inv) {
  if (inv != 0.f) return mul(a, inv);
  return div(a, b);
}

// max(x, 0) that keeps a NaN, as jnp.clip and torch.clamp do
__device__ __forceinline__ float clamp0(float x) {
  return (x < 0.f) ? 0.f : x;
}

// max of two values that keeps a NaN, as jnp.max and torch.amax do
__device__ __forceinline__ float nanmax(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// cubic spline on raw distances q >= 0 (JAX's ``kernel``)
__device__ __forceinline__ float spline(float q, float cw) {
  const float q2 = mul(q, q);
  const float inner = add(mul(6.f, sub(mul(q, q2), q2)), 1.f);
  const float u = sub(1.f, q);
  const float outer = mul(2.f, mul(u, mul(u, u)));
  return mul(cw, q <= 1.f ? (q <= 0.5f ? inner : outer) : 0.f);
}

// its derivative on signed distances (JAX's ``kernel_grad``)
__device__ __forceinline__ float spline_grad(float q, float cw) {
  const float a = fabsf(q);
  const float sg = static_cast<float>((0.f < q) - (q < 0.f));
  const float inner = sub(mul(mul(18.f, sg), mul(q, q)), mul(12.f, q));
  const float u = sub(1.f, a);
  const float outer = mul(mul(-6.f, sg), mul(u, u));
  return mul(cw, a <= 1.f ? (a <= 0.5f ? inner : outer) : 0.f);
}

// The 64-slot sum of a row spread over a group of kLanes lanes: lane g of
// the group holds the leaves of slots g + kLanes * k (leaf[k]).  The
// levels of the plain version's tree whose pairs lie in one lane (slot j
// with j + 32, j + 16, ... down to j + kLanes) are added in the lane, the
// rest by __shfl_xor_sync over kLanes / 2, ..., 1 (see the note above).
// Every lane of the group returns the sum.  All 32 lanes must call it.
template <int kLanes>
__device__ __forceinline__ float group_tree(float (&leaf)[kSlots / kLanes]) {
#pragma unroll
  for (int n = kSlots / kLanes / 2; n >= 1; n >>= 1)
#pragma unroll
    for (int k = 0; k < n; ++k) leaf[k] = add(leaf[k], leaf[k + n]);
  float s = leaf[0];
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    s = add(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// The density sum of the particle at xi, the lane's leaves at slots
// g + kLanes * k (positions xj[k]).  Adds this lane's pairs within q <= 0.5
// (the spline's inner arm) to n_in and those within 0.5 < q <= 1 (its
// outer arm) to n_out when ``count``; the spline derivatives of the same
// iteration run on the same distances, so these counts are theirs too.
template <int kLanes>
__device__ __forceinline__ float density(float xi,
                                         const float (&xj)[kSlots / kLanes],
                                         int g, int n, const Consts& c,
                                         bool count, int& n_in, int& n_out) {
  float leaf[kSlots / kLanes];
#pragma unroll
  for (int k = 0; k < kSlots / kLanes; ++k) {
    const bool in = g + kLanes * k < n;
    const float q = fabsf(sub(xi, xj[k]));
    n_in += count && in && q <= 0.5f;
    n_out += count && in && q > 0.5f && q <= 1.f;
    leaf[k] = in ? mul(c.mass, spline(q, c.cw)) : 0.f;
  }
  return group_tree<kLanes>(leaf);
}

// pressure of a density (the equation of state, clamped at 0)
__device__ __forceinline__ float pressure(float dens, const Consts& c) {
  const float r = div_c(dens, c.rest, c.rest_inv);
  const float r2 = mul(r, r);
  return clamp0(mul(c.stiff, sub(mul(mul(r, r2), mul(r2, r2)), 1.f)));
}

// Lanes a particle row.  32: a warp a row; fewer: 32 / kRowLanes rows a
// warp, each on its own lane group (see the note).
constexpr int kRowLanes = 16;

// kLanes lanes a row, kRows rows a lane group: lane group q of warp w
// takes rows (w * groups + q) + r * warps * groups for r < kRows.  Every
// lane runs every row's sums (their shuffles need the whole warp); a row
// at or past counts[s] moves no particle and writes only slots that the
// sums mask.
template <int kLanes, int kRows>
__global__ void __launch_bounds__(kMaxWarps * 32)
column_sph_kernel(const float* __restrict__ x0, const float* __restrict__ v0,
                  const int* __restrict__ counts, float* __restrict__ xs,
                  float* __restrict__ vs, int* __restrict__ iters,
                  int* __restrict__ pairs, int p,
                  int timesteps, int bcnt, int max_iter, Consts c) {
  constexpr int kGroups = 32 / kLanes;
  constexpr int kLeaves = kSlots / kLanes;
  __shared__ float x_s[2][kSlots], v_s[kSlots], aux_s[kSlots], pd_s[kSlots];
  __shared__ float err_s[kSlots];  // each row's over-density (0: no fluid)
  __shared__ int pairs_s[4];
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane % kLanes;
  const bool head = g == 0;  // the lane that writes its group's row
  const int n = counts[s];
  int row[kRows];
  bool valid[kRows], fluid[kRows], bnd = false;
  float x[kRows], v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    row[r] = warp * kGroups + lane / kLanes + r * warps * kGroups;
    valid[r] = row[r] < n;
    fluid[r] = valid[r] && row[r] >= bcnt;
    bnd |= row[r] < bcnt;
    x[r] = row[r] < p ? x0[s * p + row[r]] : 0.f;
    v[r] = row[r] < p ? v0[s * p + row[r]] : 0.f;
  }
  // a warp with a boundary row sums particle bcnt's density too
  bnd = __any_sync(0xffffffffu, bnd);
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) {
    x_s[0][i] = i < p ? x0[s * p + i] : 0.f;
    v_s[i] = i < p ? v0[s * p + i] : 0.f;
    err_s[i] = 0.f;
  }
  int cur = 0;  // the x buffer that holds the current positions
  __syncthreads();

  for (int t = 0; t < timesteps; ++t) {
    // frame t records the state before its step
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (head && row[r] < p) {
        xs[(static_cast<size_t>(s) * timesteps + t) * p + row[r]] = x[r];
        vs[(static_cast<size_t>(s) * timesteps + t) * p + row[r]] = v[r];
      }
    }
    if (threadIdx.x < 4) pairs_s[threadIdx.x] = 0;
    int cnt[4] = {0, 0, 0, 0};  // frame (inner, outer), iterations (same)
    float xj[kLeaves];

    // viscosity and gravity, then the prediction
#pragma unroll
    for (int k = 0; k < kLeaves; ++k) xj[k] = x_s[cur][g + kLanes * k];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float dens = density<kLanes>(x[r], xj, g, n, c, valid[r], cnt[0],
                                   cnt[1]);
      if (!valid[r]) dens = 1.f;
      if (head && row[r] < kSlots) aux_s[row[r]] = div(c.mass, dens);
    }
    __syncthreads();
    {
      float vj[kLeaves], aj[kLeaves];
#pragma unroll
      for (int k = 0; k < kLeaves; ++k) {
        vj[k] = v_s[g + kLanes * k];
        aj[k] = aux_s[g + kLanes * k];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float leaf[kLeaves];
#pragma unroll
        for (int k = 0; k < kLeaves; ++k) {
          const float ds = sub(x[r], xj[k]);
          leaf[k] = g + kLanes * k < n
              ? div(mul(mul(mul(aj[k], sub(v[r], vj[k])), ds),
                        spline_grad(ds, c.cw)),
                    add(mul(ds, ds), c.soft))
              : 0.f;
        }
        const float lap = mul(2.f, group_tree<kLanes>(leaf));
        if (fluid[r]) {
          v[r] = add(v[r], mul(c.dt, add(c.gravity, mul(c.visc, lap))));
          x[r] = add(x[r], mul(c.dt, v[r]));
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (head && row[r] < kSlots) {
        x_s[cur][row[r]] = x[r];
        v_s[row[r]] = v[r];
      }
    }
    __syncthreads();

    // the pressure projection: the first iteration always runs, the exit
    // test reads the err computed inside the iteration
    int it = 0;
    bool active = max_iter > 0;
    while (active) {
#pragma unroll
      for (int k = 0; k < kLeaves; ++k) xj[k] = x_s[cur][g + kLanes * k];
      float pres_b = 0.f;  // particle bcnt's pressure, for boundary rows
      if (bnd) {
        int none = 0;
        pres_b = pressure(density<kLanes>(x_s[cur][bcnt], xj, g, n, c,
                                          false, none, none), c);
      }
      float dens[kRows], pd[kRows], md[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        dens[r] = density<kLanes>(x[r], xj, g, n, c, valid[r], cnt[2],
                                  cnt[3]);
        const float pres = row[r] < bcnt ? pres_b : pressure(dens[r], c);
        pd[r] = div(pres, mul(dens[r], dens[r]));
        md[r] = div(c.mass, dens[r]);
        if (head && row[r] < kSlots) {
          pd_s[row[r]] = pd[r];
          err_s[row[r]] = fluid[r] ? clamp0(sub(dens[r], c.rest)) : 0.f;
        }
      }
      __syncthreads();
      float pdj[kLeaves];
#pragma unroll
      for (int k = 0; k < kLeaves; ++k) pdj[k] = pd_s[g + kLanes * k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float leaf[kLeaves];
#pragma unroll
        for (int k = 0; k < kLeaves; ++k) {
          leaf[k] = g + kLanes * k < n
              ? mul(mul(c.mass, add(pd[r], pdj[k])),
                    spline_grad(sub(x[r], xj[k]), c.cw))
              : 0.f;
        }
        const float sum = group_tree<kLanes>(leaf);
        const float f = mul(-md[r], mul(dens[r], sum));
        if (fluid[r]) {
          v[r] = add(v[r], div_c(mul(c.dt, f), c.mass, c.mass_inv));
          x[r] = add(x[r], div_c(mul(c.dt2, f), c.mass, c.mass_inv));
        }
        if (head && row[r] < kSlots) x_s[cur ^ 1][row[r]] = x[r];
      }
      // the block's max over the rows (exact in any order; a NaN stays a
      // NaN), off the sums' path
      float err = nanmax(err_s[lane], err_s[lane + 32]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        err = nanmax(err, __shfl_xor_sync(0xffffffffu, err, off));
      __syncthreads();
      cur ^= 1;
      ++it;
      active = it < max_iter && err >= c.eps;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (head && row[r] < kSlots) v_s[row[r]] = v[r];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // integers: any order
      const int w = __reduce_add_sync(0xffffffffu, cnt[k]);
      if (lane == 0 && w) atomicAdd(&pairs_s[k], w);
    }
    __syncthreads();
    if (threadIdx.x == 0) iters[s * timesteps + t] = it;
    if (threadIdx.x < 4)
      pairs[(static_cast<size_t>(s) * timesteps + t) * 4 + threadIdx.x] =
          pairs_s[threadIdx.x];
    __syncthreads();
  }
}

// 1 / x where x is a power of two whose inverse is a normal float, else 0
float pow2_inv(float x) {
  int e;
  return x > 0.f && std::frexp(x, &e) == 0.5f && e - 1 > -126 && e - 1 < 127
      ? std::ldexp(1.f, 1 - e) : 0.f;
}

template <int kLanes, int kRows>
void launch(int scenes, int p, cudaStream_t st, const float* x0,
            const float* v0, const int* counts, float* xs, float* vs,
            int* iters, int* pairs, int timesteps, int bcnt, int max_iter,
            const Consts& c) {
  const int rows = 32 / kLanes * kRows;  // rows a warp
  column_sph_kernel<kLanes, kRows><<<scenes, 32 * ((p + rows - 1) / rows),
                                     0, st>>>(
      x0, v0, counts, xs, vs, iters, pairs, p, timesteps, bcnt, max_iter,
      c);
}

}  // namespace

extern "C" int column_sph_launch(const float* x0, const float* v0,
                                 const int* counts, float* xs, float* vs,
                                 int* iters, int* pairs, int scenes, int p,
                                 int timesteps, int bcnt, int max_iter,
                                 float mass,
                                 float gravity, float rest, float stiff,
                                 float visc, float cw, float soft, float dt,
                                 float dt2, float eps, void* stream) {
  if (scenes <= 0) return 0;
  if (p < 1 || p > kSlots) return static_cast<int>(cudaErrorInvalidValue);
  const Consts c{mass, gravity, rest, stiff, visc, cw, soft, dt, dt2, eps,
                 pow2_inv(mass), pow2_inv(rest)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kRowLanes == 32) {  // two rows a warp past 32 warps
    if (p > kMaxWarps) {
      launch<kRowLanes, 2>(scenes, p, st, x0, v0, counts, xs, vs, iters,
                           pairs, timesteps, bcnt, max_iter, c);
      return static_cast<int>(cudaGetLastError());
    }
  }
  launch<kRowLanes, 1>(scenes, p, st, x0, v0, counts, xs, vs, iters, pairs,
                       timesteps, bcnt, max_iter, c);
  return static_cast<int>(cudaGetLastError());
}
