// SPH1D column solver for Hopper (sm_90a): the whole time integration of
// every scene of a split in one launch.
//
// Replaces dmcf_tpu/data/generators.py:_column_solve_jax, the JAX
// package's compiled solver (a lax.while_loop pressure projection inside a
// lax.scan over frames, run by XLA on the CPU; the repo has no TPU kernel
// for it).  Contract: dmcf_tpu_torch/kernels/column_sph.py.
//
// What bounds it: nothing the card is short of.  A scene is at most 64
// particles; a frame runs up to max_iter (10,000) projection iterations,
// each two all-pairs sums that depend on the previous iteration.  The work
// is a long chain of dependent, tiny steps, so it is latency-bound: ~64 x
// 2 x 25 fp32 operations an iteration against 67 TFLOP/s would take
// picoseconds, an iteration takes microseconds.  The kernel computes both
// arms of every spline and every pair, in or out of the support, and then
// selects; it counts the pairs that fall in each arm (``pairs``) so that a
// bound can count only the work the data needs.
//
// Design: one block of 64 threads a scene, thread i owns particle slot i
// (positions, velocities and per-particle terms in shared memory, all
// frames and iterations inside the kernel, no launch per iteration).  Each
// thread sums its row over the 64 zero-padded slots in one fixed tree
// order (slot j with j + 32, then j + 16, ...; the template ``tree``
// below), fully unrolled, so the sums are independent instruction streams
// and the result does not depend on scheduling: two launches give the
// same bits, and the plain version (kernels/column_sph.py, same tree)
// gives the same bits too.  Every elementwise operation is JAX's in fp32,
// written with the _rn intrinsics so that nvcc fuses no multiply-add.  A
// scene leaves its projection loop at err < eps or max_iter on its own
// (err is block-uniform after the max reduction).

#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 64;

struct Consts {
  float mass, gravity, rest, stiff, visc, cw, soft, dt, dt2, eps;
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

// sum of leaf(j) over the 64 slots in the fixed tree order
template <int L, int kStride, class Leaf>
__device__ __forceinline__ float tree(const Leaf& leaf) {
  if constexpr (kStride == kSlots) {
    return leaf(L);
  } else {
    return add(tree<L, 2 * kStride>(leaf),
               tree<L + kStride, 2 * kStride>(leaf));
  }
}

// the density sum of one particle; adds the pairs within q <= 0.5 (the
// spline's inner arm) to n_in and those within 0.5 < q <= 1 (its outer
// arm) to n_out.  The spline derivatives of the same iteration run on the
// same distances, so these counts are theirs too.
__device__ __forceinline__ float density(float xi, const float* x_s, int n,
                                         const Consts& c, int& n_in,
                                         int& n_out) {
  return tree<0, 1>([&](int j) {
    if (j >= n) return 0.f;
    const float q = fabsf(sub(xi, x_s[j]));
    n_in += q <= 0.5f;
    n_out += q > 0.5f && q <= 1.f;
    return mul(c.mass, spline(q, c.cw));
  });
}

__global__ void __launch_bounds__(kSlots)
column_sph_kernel(const float* __restrict__ x0, const float* __restrict__ v0,
                  const int* __restrict__ counts, float* __restrict__ xs,
                  float* __restrict__ vs, int* __restrict__ iters,
                  int* __restrict__ pairs, int p,
                  int timesteps, int bcnt, int max_iter, Consts c) {
  __shared__ float x_s[kSlots], v_s[kSlots], aux_s[kSlots], pd_s[kSlots];
  __shared__ float red_s[kSlots / 32];
  __shared__ int pairs_s[4];
  const int s = blockIdx.x;
  const int i = threadIdx.x;
  const int n = counts[s];
  const bool valid = i < n;
  const bool fluid = valid && i >= bcnt;
  float x = i < p ? x0[s * p + i] : 0.f;
  float v = i < p ? v0[s * p + i] : 0.f;
  x_s[i] = x;
  v_s[i] = v;
  __syncthreads();

  for (int t = 0; t < timesteps; ++t) {
    // frame t records the state before its step
    if (i < p) {
      xs[(static_cast<size_t>(s) * timesteps + t) * p + i] = x;
      vs[(static_cast<size_t>(s) * timesteps + t) * p + i] = v;
    }
    if (i < 4) pairs_s[i] = 0;
    int cnt[4] = {0, 0, 0, 0};  // frame (inner, outer), iterations (same)

    // viscosity and gravity, then the prediction
    float dens = valid ? density(x, x_s, n, c, cnt[0], cnt[1]) : 1.f;
    aux_s[i] = div(c.mass, dens);
    __syncthreads();
    if (valid) {
      const float lap = mul(2.f, tree<0, 1>([&](int j) {
        if (j >= n) return 0.f;
        const float ds = sub(x, x_s[j]);
        return div(mul(mul(mul(aux_s[j], sub(v, v_s[j])), ds),
                       spline_grad(ds, c.cw)),
                   add(mul(ds, ds), c.soft));
      }));
      if (fluid) {
        v = add(v, mul(c.dt, add(c.gravity, mul(c.visc, lap))));
        x = add(x, mul(c.dt, v));
      }
    }
    __syncthreads();
    x_s[i] = x;
    v_s[i] = v;
    __syncthreads();

    // the pressure projection: the first iteration always runs, the exit
    // test reads the err computed inside the iteration
    int it = 0;
    bool active = max_iter > 0;
    while (active) {
      dens = valid ? density(x, x_s, n, c, cnt[2], cnt[3]) : 1.f;
      const float r = div(dens, c.rest);
      const float r2 = mul(r, r);
      float pres = clamp0(mul(c.stiff, sub(mul(mul(r, r2), mul(r2, r2)),
                                           1.f)));
      aux_s[i] = pres;
      float err = fluid ? clamp0(sub(dens, c.rest)) : 0.f;
      for (int off = 16; off > 0; off >>= 1) {
        err = nanmax(err, __shfl_xor_sync(0xffffffffu, err, off));
      }
      if ((i & 31) == 0) red_s[i >> 5] = err;
      __syncthreads();
      err = nanmax(red_s[0], red_s[1]);
      if (i < bcnt) pres = aux_s[bcnt];
      pd_s[i] = div(pres, mul(dens, dens));
      __syncthreads();
      if (valid) {
        const float pdi = pd_s[i];
        const float sum = tree<0, 1>([&](int j) {
          return j < n ? mul(mul(c.mass, add(pdi, pd_s[j])),
                             spline_grad(sub(x, x_s[j]), c.cw))
                       : 0.f;
        });
        const float f = mul(-div(c.mass, dens), mul(dens, sum));
        if (fluid) {
          v = add(v, div(mul(c.dt, f), c.mass));
          x = add(x, div(mul(c.dt2, f), c.mass));
        }
      }
      __syncthreads();
      x_s[i] = x;
      __syncthreads();
      ++it;
      active = it < max_iter && err >= c.eps;
    }
    v_s[i] = v;
    for (int k = 0; k < 4; ++k) {
      if (cnt[k]) atomicAdd(&pairs_s[k], cnt[k]);  // integers: any order
    }
    __syncthreads();
    if (i == 0) iters[s * timesteps + t] = it;
    if (i < 4) pairs[(static_cast<size_t>(s) * timesteps + t) * 4 + i] =
        pairs_s[i];
    __syncthreads();
  }
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
  const Consts c{mass, gravity, rest, stiff, visc, cw, soft, dt, dt2, eps};
  column_sph_kernel<<<scenes, kSlots, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x0, v0, counts, xs, vs, iters, pairs, p, timesteps, bcnt, max_iter,
      c);
  return static_cast<int>(cudaGetLastError());
}
