// Closest-hit and any-hit traversal over per-block culled chunk worklists,
// written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of slr_tpu/accel/pallas_intersect.py and
// the instance transform that runs inside them:
//   closest_hit_kernel <- _run_kernel (_kernel / _kernel_smallwl ->
//                         _traverse_closest), the closest-hit cast;
//   any_hit_kernel     <- _run_kernel_any (_kernel_any / _kernel_any_smallwl
//                         -> _traverse_any), the shadow (occlusion) cast.
//   xform_ray (device) <- _xform_rays, the per-lane instance transform that
//                         both TPU kernels run on a ray block before the
//                         triangle tests of an instanced entry; and
//   xform_rays_kernel  <- the same device function launched on its own, so
//                         that it can be held against its plain version.
// The TPU versions' two memory placements of the worklist (SMEM prefetch or
// per-block DMA from HBM) are one kernel here: a block reads its own
// worklist row from global memory.
//
// Instanced entries. A worklist entry is a (chunk, instance) pair; instance
// -1 is static geometry in world space. For an instance >= 0 the chunk holds
// local-space triangles and the entry's box is the world-space union of the
// transformed chunk box over the shutter. The TPU writes a transformed
// (16, RB) ray block to VMEM scratch and selects it with a scalar predicate
// to feed the MXU. Here each thread owns one ray: it keeps the world ray in
// registers and, for an instanced entry, derives the local line (d, m, o) in
// registers from the 24 floats of the instance's row, which the block
// stages in shared memory beside the chunk table (the entry, and so the
// row, is uniform over the block). The box test, the suffix break, tmin,
// tmax and the running best stay in world space: the local direction is
// left unnormalized, so t is the world parameter. The transform costs ~138
// fp32 operations per (ray, instanced entry) against 128 x 45 for the chunk
// it precedes, so it adds under 1% to the kernels' bound; its code and
// registers do cost closest hit a few percent on static tables (PERF.md).
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
//   rays   (NB, 16, RB)  rows [dx dy dz mx my mz ox oy oz 1 tmin tmax f 0..]
//                        with m = o x d and f the shutter fraction; one
//                        thread per ray, one block per RB rays, so each row
//                        load is coalesced.
//   wl     (NB, NE) int32 near-sorted worklist (entries past cnt repeat)
//   wtn    (NB, NE)       sorted block-entry near distances
//   cnt    (NB,) int32
//   boxes  (NE, 8)        [lo.xyz hi.xyz nonempty pad] per entry
//   echunk (NE,) int32    chunk id per entry
//   einst  (NE,) int32    instance id per entry, -1 = static
//   inst_trs (I, 24)      per instance [T0(3) Q0(4) S0(3) T1(3) Q1(4) S1(3)
//                         theta sin(theta) pad pad]: the TRS decomposition
//                         at the shutter's two ends, Q1 flipped onto Q0's
//                         hemisphere and theta the angle between them.
//   tri24  (NC, C, 24)    per triangle [e0(6) e1(6) e2(6) n(3) d0 pad pad],
//                         e = [a x b, b - a] per edge, n = (p1-p0)x(p2-p0),
//                         d0 = n.p0; padding slots are all zero (n.d = 0
//                         fails the |den| test).
// Outputs: best_t (NB, RB), best_idx = chunk*C + slot (-1 on a miss) and
// best_inst = the winning entry's instance (-1 for a static entry or a
// miss); or occluded (NB, RB) int32. `tests` (NB,) int32, optional: the
// number of ray-triangle tests the block's rays need, those of live (any
// hit: still open) rays against the triangles of chunks whose box they meet
// (what the bound is computed from; the block runs more: the chunk's zero
// padding slots, and rays that share its chunk loads). With `tests` goes
// `nvalid` (NC,) int32, the triangles each chunk holds: they fill its first
// slots. `xforms` (NB,) int32, optional: the (ray, instanced entry)
// transforms among those tests.
//
// Compiled with --fmad=false: each product and sum is rounded on its own,
// in the same order as the plain PyTorch versions in accel/traverse.py. The
// transform uses sinf, rsqrtf and plain divides, never the fast intrinsics.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;
constexpr int KCOLS = 24;
constexpr int MAX_CHUNK = 128;
constexpr float T_FAR = 3e38f;

constexpr int TRS_COLS = 24;

// A ray as the triangle tests read it: direction, moment o x d, origin.
struct Line {
  float dx, dy, dz, mx, my, mz, ox, oy, oz;
};

struct Ray {
  Line w;  // the world-space ray
  float tmin, tmax;
  float f;           // shutter fraction
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
  r.w.dx = rr[0 * rb];
  r.w.dy = rr[1 * rb];
  r.w.dz = rr[2 * rb];
  r.w.mx = rr[3 * rb];
  r.w.my = rr[4 * rb];
  r.w.mz = rr[5 * rb];
  r.w.ox = rr[6 * rb];
  r.w.oy = rr[7 * rb];
  r.w.oz = rr[8 * rb];
  r.tmin = rr[10 * rb];
  r.tmax = rr[11 * rb];
  r.f = rr[12 * rb];
  r.ix = safe_inv(r.w.dx);
  r.iy = safe_inv(r.w.dy);
  r.iz = safe_inv(r.w.dz);
  return r;
}

// R^-1 v = v + 2 (-qw (u x v) + u x (u x v)), u = (qx, qy, qz).
__device__ __forceinline__ void inv_rotate(float qx, float qy, float qz,
                                           float qw, float vx, float vy,
                                           float vz, float& rx, float& ry,
                                           float& rz) {
  const float cx = qy * vz - qz * vy;
  const float cy = qz * vx - qx * vz;
  const float cz = qx * vy - qy * vx;
  const float ex = qy * cz - qz * cy;
  const float ey = qz * cx - qx * cz;
  const float ez = qx * cy - qy * cx;
  rx = vx + 2.0f * (-qw * cx + ex);
  ry = vy + 2.0f * (-qw * cy + ey);
  rz = vz + 2.0f * (-qw * cz + ez);
}

// The world ray `w` into the local space of the instance whose row is `c`
// (24 floats, see inst_trs above), at shutter fraction f: slerp of the
// rotation (a lerp where sin(theta) < 1e-4), renormalized; lerp of T and S;
// o_l = R^-1 (o - T) / S, d_l = R^-1 d / S, m = o_l x d_l. S may be
// negative (a mirrored instance). Step for step `xform_rays_plain`.
__device__ __forceinline__ Line xform_ray(const float* c, const Line& w,
                                          float f) {
  const float theta = c[20], sin_t = c[21];
  const bool lerp_only = sin_t < 1e-4f;
  const float inv_sin = 1.0f / (lerp_only ? 1.0f : sin_t);
  const float one_f = 1.0f - f;
  const float w0 = lerp_only ? one_f : sinf(one_f * theta) * inv_sin;
  const float w1 = lerp_only ? f : sinf(f * theta) * inv_sin;
  float qx = w0 * c[3] + w1 * c[13];
  float qy = w0 * c[4] + w1 * c[14];
  float qz = w0 * c[5] + w1 * c[15];
  float qw = w0 * c[6] + w1 * c[16];
  const float qn =
      rsqrtf(fmaxf(qx * qx + qy * qy + qz * qz + qw * qw, 1e-20f));
  qx = qx * qn;
  qy = qy * qn;
  qz = qz * qn;
  qw = qw * qn;
  const float tx = one_f * c[0] + f * c[10];
  const float ty = one_f * c[1] + f * c[11];
  const float tz = one_f * c[2] + f * c[12];
  const float inv_sx = 1.0f / (one_f * c[7] + f * c[17]);
  const float inv_sy = 1.0f / (one_f * c[8] + f * c[18]);
  const float inv_sz = 1.0f / (one_f * c[9] + f * c[19]);
  Line l;
  float olx, oly, olz;
  inv_rotate(qx, qy, qz, qw, w.ox - tx, w.oy - ty, w.oz - tz, olx, oly, olz);
  olx = olx * inv_sx;
  oly = oly * inv_sy;
  olz = olz * inv_sz;
  inv_rotate(qx, qy, qz, qw, w.dx, w.dy, w.dz, l.dx, l.dy, l.dz);
  l.dx = l.dx * inv_sx;
  l.dy = l.dy * inv_sy;
  l.dz = l.dz * inv_sz;
  l.mx = oly * l.dz - olz * l.dy;
  l.my = olz * l.dx - olx * l.dz;
  l.mz = olx * l.dy - oly * l.dx;
  l.ox = olx;
  l.oy = oly;
  l.oz = olz;
  return l;
}

// Slab test of one entry box: can this ray meet the box within
// [tmin, upper]? The same predicate as the worklist builder.
__device__ __forceinline__ bool box_hit(const float* __restrict__ box,
                                        const Ray& r, float upper) {
  float tn = -T_FAR, tf = T_FAR;
  float t0 = (box[0] - r.w.ox) * r.ix, t1 = (box[3] - r.w.ox) * r.ix;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (box[1] - r.w.oy) * r.iy;
  t1 = (box[4] - r.w.oy) * r.iy;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (box[2] - r.w.oz) * r.iz;
  t1 = (box[5] - r.w.oz) * r.iz;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  return tn <= tf && tf >= r.tmin && tn <= upper;
}

// Cooperative copy of one chunk table (chunk * 24 floats) into shared
// memory and, for an instanced entry, of the instance's row beside it.
__device__ __forceinline__ void load_entry(float* sm, float* strs,
                                           const float* __restrict__ tri24,
                                           const float* __restrict__ inst_trs,
                                           int c, int inst, int chunk) {
  const float4* src =
      reinterpret_cast<const float4*>(tri24 + (size_t)c * chunk * KCOLS);
  float4* dst = reinterpret_cast<float4*>(sm);
  for (int i = threadIdx.x; i < chunk * KCOLS / 4; i += blockDim.x) {
    dst[i] = src[i];
  }
  if (inst >= 0 && threadIdx.x < TRS_COLS) {
    strs[threadIdx.x] = inst_trs[(size_t)inst * TRS_COLS + threadIdx.x];
  }
}

struct Terms {
  bool through;  // the three edge sides share a sign
  float den;     // n.d
  float num;     // d0 - n.o  (= t * den)
};

__device__ __forceinline__ Terms plucker(const float* T, const Line& r) {
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

// out[blockIdx.x] = the sum of `mine` over the block (out may be null; the
// pointer is uniform over the block).
__device__ __forceinline__ void block_total(int* __restrict__ out, int mine) {
  __shared__ int total;
  if (out == nullptr) return;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  atomicAdd(&total, mine);
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = total;
  __syncthreads();  // the next call resets `total`
}

__global__ void closest_hit_kernel(
    const float* __restrict__ rays, const int* __restrict__ wl,
    const float* __restrict__ wtn, const int* __restrict__ cnt,
    const float* __restrict__ boxes, const int* __restrict__ echunk,
    const int* __restrict__ einst, const float* __restrict__ inst_trs,
    const float* __restrict__ tri24, float* __restrict__ best_t,
    int* __restrict__ best_idx, int* __restrict__ best_inst,
    const int* __restrict__ nvalid, int* __restrict__ tests,
    int* __restrict__ xforms, int ne, int chunk) {
  __shared__ __align__(16) float sm[MAX_CHUNK * KCOLS];
  __shared__ float strs[TRS_COLS];
  const int b = blockIdx.x, t = threadIdx.x, rb = blockDim.x;
  const Ray r = load_ray(rays, b, t, rb);
  float best = r.tmax;
  int idx = -1;
  int binst = -1;
  int tested = 0, xformed = 0;
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
    const int inst = einst[e];
    load_entry(sm, strs, tri24, inst_trs, c, inst, chunk);
    __syncthreads();
    // Every thread runs the whole chunk, but only a ray that meets the box
    // needs the tests of its triangles (and its transform): those are the
    // ones counted.
    if (mine) {
      if (tests != nullptr) tested += nvalid[c];
      if (inst >= 0) ++xformed;
    }
    // The chunk's triangles live in world space (static entry) or in the
    // instance's local space; t is the world parameter in both.
    const Line l = inst >= 0 ? xform_ray(strs, r.w, r.f) : r.w;
    float cbest = best;
    int cslot = -1;
    for (int s = 0; s < chunk; ++s) {
      const Terms p = plucker(sm + s * KCOLS, l);
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
      binst = inst;
    }
    __syncthreads();  // the next entry overwrites sm and strs
  }
  const size_t o = (size_t)b * rb + t;
  best_t[o] = best;
  best_idx[o] = idx;
  best_inst[o] = binst;
  block_total(tests, tested);
  block_total(xforms, xformed);
}

__global__ void any_hit_kernel(
    const float* __restrict__ rays, const int* __restrict__ wl,
    const float* __restrict__ wtn, const int* __restrict__ cnt,
    const float* __restrict__ boxes, const int* __restrict__ echunk,
    const int* __restrict__ einst, const float* __restrict__ inst_trs,
    const float* __restrict__ tri24, int* __restrict__ occluded,
    const int* __restrict__ nvalid, int* __restrict__ tests,
    int* __restrict__ xforms, int ne, int chunk) {
  __shared__ __align__(16) float sm[MAX_CHUNK * KCOLS];
  __shared__ float strs[TRS_COLS];
  const int b = blockIdx.x, t = threadIdx.x, rb = blockDim.x;
  const Ray r = load_ray(rays, b, t, rb);
  // Inactive and padding lanes carry the inverted range [T_FAR, -T_FAR].
  const bool live = r.tmax >= r.tmin;
  bool occ = false;
  int tested = 0, xformed = 0;
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
    const int inst = einst[e];
    load_entry(sm, strs, tri24, inst_trs, c, inst, chunk);
    __syncthreads();
    // Open rays outside the box run the chunk too, as the plain version
    // does; only the tests of rays that meet the box are counted, up to the
    // first hit and over the chunk's triangles, not its padding.
    if (open) {
      if (mine && inst >= 0) ++xformed;
      const int counted = mine && tests != nullptr ? nvalid[c] : 0;
      const Line l = inst >= 0 ? xform_ray(strs, r.w, r.f) : r.w;
      for (int s = 0; s < chunk; ++s) {
        if (s < counted) ++tested;
        const Terms p = plucker(sm + s * KCOLS, l);
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
  block_total(tests, tested);
  block_total(xforms, xformed);
}

// The instance transform on its own: block b's rays into the local space of
// the instance row trs_rows[b]; out (NB, 9, RB) rows [d, m, o].
__global__ void xform_rays_kernel(const float* __restrict__ rays,
                                  const float* __restrict__ trs_rows,
                                  float* __restrict__ out) {
  __shared__ float strs[TRS_COLS];
  const int b = blockIdx.x, t = threadIdx.x, rb = blockDim.x;
  if (t < TRS_COLS) strs[t] = trs_rows[(size_t)b * TRS_COLS + t];
  const Ray r = load_ray(rays, b, t, rb);
  __syncthreads();
  const Line l = xform_ray(strs, r.w, r.f);
  float* oo = out + (size_t)b * 9 * rb + t;
  oo[0 * rb] = l.dx;
  oo[1 * rb] = l.dy;
  oo[2 * rb] = l.dz;
  oo[3 * rb] = l.mx;
  oo[4 * rb] = l.my;
  oo[5 * rb] = l.mz;
  oo[6 * rb] = l.ox;
  oo[7 * rb] = l.oy;
  oo[8 * rb] = l.oz;
}

}  // namespace

extern "C" {

int slr_closest_hit(const float* rays, const int* wl, const float* wtn,
                    const int* cnt, const float* boxes, const int* echunk,
                    const int* einst, const float* inst_trs,
                    const float* tri24, float* best_t, int* best_idx,
                    int* best_inst, const int* nvalid, int* tests,
                    int* xforms, int nb, int rb, int ne, int chunk,
                    void* stream) {
  if (nb > 0) {
    closest_hit_kernel<<<nb, rb, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, wl, wtn, cnt, boxes, echunk, einst, inst_trs, tri24, best_t,
        best_idx, best_inst, nvalid, tests, xforms, ne, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

int slr_any_hit(const float* rays, const int* wl, const float* wtn,
                const int* cnt, const float* boxes, const int* echunk,
                const int* einst, const float* inst_trs, const float* tri24,
                int* occluded, const int* nvalid, int* tests, int* xforms,
                int nb, int rb, int ne, int chunk, void* stream) {
  if (nb > 0) {
    any_hit_kernel<<<nb, rb, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, wl, wtn, cnt, boxes, echunk, einst, inst_trs, tri24, occluded,
        nvalid, tests, xforms, ne, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

int slr_xform_rays(const float* rays, const float* trs_rows, float* out,
                   int nb, int rb, void* stream) {
  if (nb > 0) {
    xform_rays_kernel<<<nb, rb, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, trs_rows, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* slr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
