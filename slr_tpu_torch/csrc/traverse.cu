// Closest-hit and any-hit traversal over per-block culled chunk worklists,
// written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of slr_tpu/accel/pallas_intersect.py:
//   closest_hit_kernel <- _run_kernel (_kernel / _kernel_smallwl ->
//                         _traverse_closest), the closest-hit cast;
//   any_hit_kernel     <- _run_kernel_any (_kernel_any / _kernel_any_smallwl
//                         -> _traverse_any), the shadow (occlusion) cast.
// The TPU versions' two memory placements of the worklist (SMEM prefetch or
// per-block DMA from HBM) are one kernel here: a block reads its own
// worklist row from global memory.
//
// What bounds it on an H100: arithmetic. Each ray-triangle test is ~45 fp32
// operations (three 6-term Plücker side products, n.d, d0 - n.o and a
// divide) against 96 bytes of triangle data that a whole block of rays
// shares, so the triangle bytes are read from shared memory, not DRAM, and
// DRAM traffic is the packed rays plus one 12 KB chunk table per visited
// entry. The design keeps the work near what the rays need: a block visits
// only entries that some ray of the block can hit below its current bound
// (a block-wide box test, __syncthreads_or), stops at the first
// near-sorted entry that lies beyond every ray's bound (__syncthreads_and),
// and the any-hit kernel stops once every live ray is occluded.
// What holds it back from that bound: one thread per ray gives the main
// path's 49,152 lanes only ~12 resident warps per SM, too few to hide the
// latency of the dependent multiply-add chains and shared-memory loads, so
// the kernels run far below the fp32 floor (PERF.md has the measured
// share). More threads per ray and multi-buffered chunk loads are the
// next steps.
//
// Layouts (all row-major, float32 unless noted):
//   rays   (NB, 16, RB)  rows [dx dy dz mx my mz ox oy oz 1 tmin tmax 0..]
//                        with m = o x d; one thread per ray, one block per
//                        RB rays, so each row load is coalesced.
//   wl     (NB, NE) int32 near-sorted worklist (entries past cnt repeat)
//   wtn    (NB, NE)       sorted block-entry near distances
//   cnt    (NB,) int32
//   boxes  (NE, 8)        [lo.xyz hi.xyz nonempty pad] per entry
//   echunk (NE,) int32    chunk id per entry
//   tri24  (NC, C, 24)    per triangle [e0(6) e1(6) e2(6) n(3) d0 pad pad],
//                         e = [a x b, b - a] per edge, n = (p1-p0)x(p2-p0),
//                         d0 = n.p0; padding slots are all zero (n.d = 0
//                         fails the |den| test).
// Outputs: best_t (NB, RB), best_idx = chunk*C + slot (-1 on a miss) and
// best_inst = -1 (instanced tables are refused by the wrapper); or
// occluded (NB, RB) int32. `tests` (NB,) int32, optional: the number of
// ray-triangle tests the block's rays need, those of live (any hit: still
// open) rays against chunks whose box they meet (what the bound is computed
// from; the block may run more, for rays that share its chunk loads).
//
// Compiled with --fmad=false: each product and sum is rounded on its own,
// in the same order as the plain PyTorch versions in accel/traverse.py.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;
constexpr int KCOLS = 24;
constexpr int MAX_CHUNK = 128;
constexpr float T_FAR = 3e38f;

struct Ray {
  float dx, dy, dz, mx, my, mz, ox, oy, oz, tmin, tmax;
  float ix, iy, iz;  // guarded reciprocal directions for the slab test
};

__device__ __forceinline__ float safe_inv(float d) {
  const float dd = fabsf(d) < 1e-20f ? (d >= 0.0f ? 1e-20f : -1e-20f) : d;
  return 1.0f / dd;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        int b, int t, int rb) {
  const float* rr = rays + (size_t)b * ROWS * rb + t;
  Ray r;
  r.dx = rr[0 * rb];
  r.dy = rr[1 * rb];
  r.dz = rr[2 * rb];
  r.mx = rr[3 * rb];
  r.my = rr[4 * rb];
  r.mz = rr[5 * rb];
  r.ox = rr[6 * rb];
  r.oy = rr[7 * rb];
  r.oz = rr[8 * rb];
  r.tmin = rr[10 * rb];
  r.tmax = rr[11 * rb];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// Slab test of one entry box: can this ray meet the box within
// [tmin, upper]? The same predicate as the worklist builder.
__device__ __forceinline__ bool box_hit(const float* __restrict__ box,
                                        const Ray& r, float upper) {
  float tn = -T_FAR, tf = T_FAR;
  float t0 = (box[0] - r.ox) * r.ix, t1 = (box[3] - r.ox) * r.ix;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (box[1] - r.oy) * r.iy;
  t1 = (box[4] - r.oy) * r.iy;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (box[2] - r.oz) * r.iz;
  t1 = (box[5] - r.oz) * r.iz;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  return tn <= tf && tf >= r.tmin && tn <= upper;
}

// Cooperative copy of one chunk table (chunk * 24 floats) into shared memory.
__device__ __forceinline__ void load_chunk(float* sm,
                                           const float* __restrict__ tri24,
                                           int c, int chunk) {
  const float4* src =
      reinterpret_cast<const float4*>(tri24 + (size_t)c * chunk * KCOLS);
  float4* dst = reinterpret_cast<float4*>(sm);
  for (int i = threadIdx.x; i < chunk * KCOLS / 4; i += blockDim.x) {
    dst[i] = src[i];
  }
}

struct Terms {
  bool through;  // the three edge sides share a sign
  float den;     // n.d
  float num;     // d0 - n.o  (= t * den)
};

__device__ __forceinline__ Terms plucker(const float* T, const Ray& r) {
  const float s0 = r.dx * T[0] + r.dy * T[1] + r.dz * T[2] + r.mx * T[3] +
                   r.my * T[4] + r.mz * T[5];
  const float s1 = r.dx * T[6] + r.dy * T[7] + r.dz * T[8] + r.mx * T[9] +
                   r.my * T[10] + r.mz * T[11];
  const float s2 = r.dx * T[12] + r.dy * T[13] + r.dz * T[14] +
                   r.mx * T[15] + r.my * T[16] + r.mz * T[17];
  Terms out;
  out.through = (s0 >= 0.0f && s1 >= 0.0f && s2 >= 0.0f) ||
                (s0 <= 0.0f && s1 <= 0.0f && s2 <= 0.0f);
  out.den = T[18] * r.dx + T[19] * r.dy + T[20] * r.dz;
  out.num = T[21] - (T[18] * r.ox + T[19] * r.oy + T[20] * r.oz);
  return out;
}

// tests[blockIdx.x] = the sum of `mine` over the block.
__device__ __forceinline__ void block_total(int* __restrict__ tests,
                                            int mine) {
  __shared__ int total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  atomicAdd(&total, mine);
  __syncthreads();
  if (threadIdx.x == 0) tests[blockIdx.x] = total;
}

__global__ void closest_hit_kernel(
    const float* __restrict__ rays, const int* __restrict__ wl,
    const float* __restrict__ wtn, const int* __restrict__ cnt,
    const float* __restrict__ boxes, const int* __restrict__ echunk,
    const float* __restrict__ tri24, float* __restrict__ best_t,
    int* __restrict__ best_idx, int* __restrict__ best_inst,
    int* __restrict__ tests, int ne, int chunk) {
  __shared__ __align__(16) float sm[MAX_CHUNK * KCOLS];
  const int b = blockIdx.x, t = threadIdx.x, rb = blockDim.x;
  const Ray r = load_ray(rays, b, t, rb);
  float best = r.tmax;
  int idx = -1;
  int tested = 0;
  const int n = cnt[b];
  const int* wlb = wl + (size_t)b * ne;
  const float* wtnb = wtn + (size_t)b * ne;
  // Inactive and padding lanes carry the inverted range [T_FAR, -T_FAR].
  const bool live = r.tmax >= r.tmin;
  for (int k = 0; k < n; ++k) {
    // Near-sorted suffix break: this entry (and every later one) starts
    // beyond every ray's current bound.
    if (__syncthreads_and(wtnb[k] > best)) break;
    const int e = wlb[k];
    const bool mine = live && box_hit(boxes + 8 * e, r, best);
    if (!__syncthreads_or(mine)) continue;
    const int c = echunk[e];
    load_chunk(sm, tri24, c, chunk);
    __syncthreads();
    // Every thread runs the chunk, but only a ray that meets the box needs
    // its tests: those are the ones counted.
    if (mine) tested += chunk;
    float cbest = best;
    int cslot = -1;
    for (int s = 0; s < chunk; ++s) {
      const Terms p = plucker(sm + s * KCOLS, r);
      const bool ok = fabsf(p.den) > 1e-12f;
      const float tt = p.num / (ok ? p.den : 1.0f);
      // Strict < keeps the first slot on a tie, as argmin does.
      if (p.through && ok && tt >= r.tmin && tt < cbest) {
        cbest = tt;
        cslot = s;
      }
    }
    if (cslot >= 0) {
      best = cbest;
      idx = c * chunk + cslot;
    }
    __syncthreads();  // the next entry overwrites sm
  }
  const size_t o = (size_t)b * rb + t;
  best_t[o] = best;
  best_idx[o] = idx;
  best_inst[o] = -1;
  if (tests != nullptr) block_total(tests, tested);
}

__global__ void any_hit_kernel(
    const float* __restrict__ rays, const int* __restrict__ wl,
    const float* __restrict__ wtn, const int* __restrict__ cnt,
    const float* __restrict__ boxes, const int* __restrict__ echunk,
    const float* __restrict__ tri24, int* __restrict__ occluded,
    int* __restrict__ tests, int ne, int chunk) {
  __shared__ __align__(16) float sm[MAX_CHUNK * KCOLS];
  const int b = blockIdx.x, t = threadIdx.x, rb = blockDim.x;
  const Ray r = load_ray(rays, b, t, rb);
  // Inactive and padding lanes carry the inverted range [T_FAR, -T_FAR].
  const bool live = r.tmax >= r.tmin;
  bool occ = false;
  int tested = 0;
  const int n = cnt[b];
  const int* wlb = wl + (size_t)b * ne;
  const float* wtnb = wtn + (size_t)b * ne;
  for (int k = 0; k < n; ++k) {
    const bool open = live && !occ;
    // Stop once every live ray is occluded, or the next entry starts
    // beyond every open ray's tmax.
    if (__syncthreads_and(!open || wtnb[k] > r.tmax)) break;
    const int e = wlb[k];
    const bool mine = open && box_hit(boxes + 8 * e, r, r.tmax);
    if (!__syncthreads_or(mine)) continue;
    const int c = echunk[e];
    load_chunk(sm, tri24, c, chunk);
    __syncthreads();
    // Open rays outside the box run the chunk too, as the plain version
    // does; only the tests of rays that meet the box are counted.
    if (open) {
      for (int s = 0; s < chunk; ++s) {
        if (mine) ++tested;
        const Terms p = plucker(sm + s * KCOLS, r);
        // Divide-free range test: t = num/den lies in [tmin, tmax] iff
        // (num - tmin*den) and (num - tmax*den) differ in sign.
        const float lo = p.num - r.tmin * p.den;
        const float hi = p.num - r.tmax * p.den;
        if (p.through && lo * hi <= 0.0f && fabsf(p.den) > 1e-12f) {
          occ = true;
          break;
        }
      }
    }
    __syncthreads();
  }
  occluded[(size_t)b * rb + t] = occ ? 1 : 0;
  if (tests != nullptr) block_total(tests, tested);
}

}  // namespace

extern "C" {

int slr_closest_hit(const float* rays, const int* wl, const float* wtn,
                    const int* cnt, const float* boxes, const int* echunk,
                    const float* tri24, float* best_t, int* best_idx,
                    int* best_inst, int* tests, int nb, int rb, int ne,
                    int chunk, void* stream) {
  if (nb > 0) {
    closest_hit_kernel<<<nb, rb, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, wl, wtn, cnt, boxes, echunk, tri24, best_t, best_idx,
        best_inst, tests, ne, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

int slr_any_hit(const float* rays, const int* wl, const float* wtn,
                const int* cnt, const float* boxes, const int* echunk,
                const float* tri24, int* occluded, int* tests, int nb,
                int rb, int ne, int chunk, void* stream) {
  if (nb > 0) {
    any_hit_kernel<<<nb, rb, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, wl, wtn, cnt, boxes, echunk, tri24, occluded, tests, ne,
        chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* slr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
