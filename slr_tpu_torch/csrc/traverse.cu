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
// worklist_kernel, the worklist build of a cast, replaces no TPU kernel
// (see its note below).
// The TPU versions' two memory placements of the worklist (SMEM prefetch or
// per-block DMA from HBM) are one kernel here: a block reads its own
// worklist row from global memory.
//
// Instanced entries. A worklist entry is a (chunk, instance) pair; instance
// -1 is static geometry in world space. For an instance >= 0 the chunk holds
// local-space triangles and the entry's box is the world-space union of the
// transformed chunk box over the shutter. The TPU writes a transformed
// (16, RB) ray block to VMEM scratch and selects it with a scalar predicate
// to feed the MXU. Here the block keeps its world rays in shared memory and,
// for an instanced entry, the owner thread of each ray that meets the
// entry's box derives the local line (d, m, o) once from the 24 floats of
// the instance's row and writes it to shared memory beside the world one.
// The box test, the suffix break, tmin, tmax and the running best stay in
// world space: the local direction is left unnormalized, so t is the world
// parameter. The transform costs ~138 fp32 operations per (ray, instanced
// entry). Tables without an instanced entry run an instantiation
// (`INSTANCED = false`) that holds none of this.
//
// What bounds it on an H100: arithmetic. Each ray-triangle test is ~45 fp32
// operations (three 6-term Plücker side products, n.d, d0 - n.o and a
// divide) against 96 bytes of triangle data that a whole block of rays
// shares, so the triangle bytes are read from shared memory, not DRAM, and
// DRAM traffic is the packed rays plus one chunk table per visited entry
// (which the 50 MB L2 holds). The signs of the side products decide a hit,
// so the tests stay in fp32 outside the tensor cores (TF32 keeps ~3 digits).
//
// What held the first version back (one thread per ray, every thread running
// all 128 slots of every chunk its block visited): a block ran 5-30 times
// the tests its rays needed, since few rays of a block meet a given entry's
// box and an instanced chunk fills a fifth of its slots; 8-16 warps per SM
// each ran one dependent chain per test; and per entry the block paid two
// block-wide votes, a chain of dependent global loads (worklist -> box ->
// chunk) and a synchronous 12 KB copy, with nothing overlapped.
//
// What this design does about it:
//  1. Work trimmed to what is there. Slot loops and chunk copies run to the
//     chunk's triangle count `nvalid[c]` (triangles fill a chunk's first
//     slots), and the traversal is compiled per `INSTANCED`.
//  2. Per-ray culling with ray compaction. The block's rays and their
//     running results live in shared memory. Only the rays whose own slab
//     test meets an entry's box (widened by MARGIN, see `box_near`) are
//     listed for it; the listed rays are compacted and the whole block works
//     on them: a work item is (listed ray, sub-lane g of G), G a power of
//     two up to 32 chosen so that the items fill the block; an item tests
//     slots g, g + G, ...; a shuffle reduction over the G sub-lanes keeps
//     the smallest t and, on equal t, the lowest slot (the sequential
//     strict `<`); any hit reduces with a ballot and leaves at the first
//     hit. With every ray listed G = 1 and the loop is the first version's.
//     Triangle rows are staged with a 112 B stride and read as six float4,
//     so that sub-lanes on neighbouring slots meet no bank conflict.
//  3. Chunk copies by `cp.async` (16 B a thread, no registers staged),
//     under which the block compacts the entry's ray list once more where
//     that pays (below) and the owners of the listed rays derive their
//     local lines. A ring of two or three chunk tables, with the next
//     listed entries' copies in flight while one is tested, was built and
//     measured: within 3% either way, slower on six of eight ray sets
//     (PERF.md), so one table is staged at a time.
//  4. One scan per group of SCAN_W worklist entries instead of two votes per
//     entry: SCAN_W threads fetch the group's boxes, chunk ids and instance
//     rows together, every owner tests its ray against all of them, and
//     warp-aggregated atomics build the per-entry ray lists. The near-sorted
//     suffix break is evaluated once per group; a listed ray is re-checked
//     against its current bound (its stored box-near distance, or its
//     occluded flag) when its item starts. Two barriers per visited entry.
//     Rays listed for an earlier entry of the same group too may be done
//     by the time an entry's turn comes (their bound has shrunk, or they are
//     occluded). In the any-hit kernel, where most rays end at their first
//     hit, an entry's list is compacted once more under the chunk copy
//     wherever the list without those rays would give each ray more
//     sub-lanes, so that dead rays cost none. Closest hit gains from that
//     only on camera rays (5%) and loses 1-6% on the other sets, so it
//     does without (PERF.md).
// The kernels are compiled for at least MIN_BLOCKS resident blocks of 256
// lanes (`__launch_bounds__`), which also keeps ptxas from spilling a few
// registers to reach a higher occupancy.
// Per-ray culling changes no result as long as a ray is listed for every
// entry that holds a triangle it hits; MARGIN covers the rounding of the
// slab test at a box face (PERF.md has the counts).
//
// Layouts (all row-major, float32 unless noted):
//   rays   (NB, 16, RB)  rows [dx dy dz mx my mz ox oy oz 1 tmin tmax f 0..]
//                        with m = o x d and f the shutter fraction; one
//                        owner thread per ray, one block per RB rays, so
//                        each row load is coalesced.
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
//   nvalid (NC,) int32    the triangles each chunk holds: they fill its
//                         first slots.
// Outputs: best_t (NB, RB), best_idx = chunk*C + slot (-1 on a miss) and
// best_inst = the winning entry's instance (-1 for a static entry or a
// miss); or occluded (NB, RB) int32. Optional counters, all int32:
// `tests` (NB,), the ray-triangle tests the block's rays need, those of live
// (any hit: still open) rays against the triangles of chunks whose box they
// meet by the exact slab test (any hit: up to the first hit), which is what
// the bound is computed from; `xforms` (NB,), the (ray, instanced entry)
// transforms among those tests; `ran` (NB, 2), the slot tests the block
// executed and the (ray, entry) pairs that only the margin listed.
//
// Compiled with --fmad=false: each product and sum is rounded on its own,
// in the same order as the plain PyTorch versions in accel/traverse.py. The
// transform uses sinf, rsqrtf and plain divides, never the fast intrinsics.

#include <cuda_runtime.h>

#ifndef SLR_SCAN_W
#define SLR_SCAN_W 8  // worklist entries scanned together (1..32)
#endif
#ifndef SLR_RELIST
#define SLR_RELIST 1  // compact an entry's ray list a second time: 0 never,
#endif                // 1 in the any-hit kernel, 2 in both

namespace {

constexpr int ROWS = 16;
constexpr int KCOLS = 24;
constexpr int MAX_CHUNK = 128;
constexpr float T_FAR = 3e38f;
constexpr int TRS_COLS = 24;

constexpr int SCAN_W = SLR_SCAN_W;
constexpr int RELIST_MODE = SLR_RELIST;
constexpr int MIN_BLOCKS = 2;  // resident blocks of MAX_RB lanes built for
constexpr int MAX_RB = 256;
constexpr int SROW = 28;     // floats per staged triangle row (112 B)
constexpr int RAY_ROWS = 12; // d, m, o, tmin, bound, f
constexpr unsigned FULL = 0xffffffffu;
// The per-ray box test widens each box face by MARGIN * (1 + the largest
// coordinate of the box and of the ray's origin).
constexpr float MARGIN = 1e-4f;

static_assert(SCAN_W >= 1 && SCAN_W <= 32, "SLR_SCAN_W out of range");

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

// Slab test of one entry box `lo..hi` widened by `pad` on every face: can
// the ray (origin o, guarded reciprocal direction i) meet it within
// [tmin, upper]? `tn` receives the near distance. With pad = 0 this is the
// exact predicate of `_chunk_worklist` (accel/traverse.py).
__device__ __forceinline__ bool box_near(const float* __restrict__ box,
                                         float pad, float ox, float oy,
                                         float oz, float ix, float iy,
                                         float iz, float tmin, float upper,
                                         float& tn) {
  float tf = T_FAR;
  tn = -T_FAR;
  float t0 = ((box[0] - pad) - ox) * ix, t1 = ((box[3] + pad) - ox) * ix;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = ((box[1] - pad) - oy) * iy;
  t1 = ((box[4] + pad) - oy) * iy;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = ((box[2] - pad) - oz) * iz;
  t1 = ((box[5] + pad) - oz) * iz;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  return tn <= tf && tf >= tmin && tn <= upper;
}

__device__ __forceinline__ float max_abs3(float a, float b, float c) {
  return fmaxf(fmaxf(fabsf(a), fabsf(b)), fabsf(c));
}

struct Terms {
  bool through;  // the three edge sides share a sign
  float den;     // n.d
  float num;     // d0 - n.o  (= t * den)
};

// One triangle row, staged as six float4 (columns 0-23), against a line.
__device__ __forceinline__ Terms plucker(const float4* T, const Line& r) {
  const float4 a = T[0], b = T[1], c = T[2], d = T[3], e = T[4], f = T[5];
  const float s0 = r.dx * a.x + r.dy * a.y + r.dz * a.z + r.mx * a.w +
                   r.my * b.x + r.mz * b.y;
  const float s1 = r.dx * b.z + r.dy * b.w + r.dz * c.x + r.mx * c.y +
                   r.my * c.z + r.mz * c.w;
  const float s2 = r.dx * d.x + r.dy * d.y + r.dz * d.z + r.mx * d.w +
                   r.my * e.x + r.mz * e.y;
  Terms out;
  out.through = (s0 >= 0.0f && s1 >= 0.0f && s2 >= 0.0f) ||
                (s0 <= 0.0f && s1 <= 0.0f && s2 <= 0.0f);
  out.den = e.z * r.dx + e.w * r.dy + f.x * r.dz;
  out.num = f.y - (e.z * r.ox + e.w * r.oy + f.x * r.oz);
  return out;
}

// out[blockIdx.x * stride] = the sum of `mine` over the block (out may be
// null; the pointer is uniform over the block).
__device__ __forceinline__ void block_total(int* __restrict__ out, int stride,
                                            int mine) {
  __shared__ int total;
  if (out == nullptr) return;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  atomicAdd(&total, mine);
  __syncthreads();
  if (threadIdx.x == 0) out[(size_t)blockIdx.x * stride] = total;
  __syncthreads();  // the next call resets `total`
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Start the copy of chunk c's first nv triangle rows (96 B each) into the
// staged table (112 B a row); the caller commits the group.
__device__ __forceinline__ void copy_chunk(float* slot,
                                           const float* __restrict__ tri24,
                                           int c, int chunk, int nv) {
  const float4* src =
      reinterpret_cast<const float4*>(tri24 + (size_t)c * chunk * KCOLS);
  float4* dst = reinterpret_cast<float4*>(slot);
  for (int i = threadIdx.x; i < nv * 6; i += blockDim.x) {
    const int s = i / 6;
    cp_async16(dst + s * 7 + (i - s * 6), src + i);
  }
}

// Shared-memory plan of one block, in 4-byte words. The same function sizes
// the launch on the host.
struct Plan {
  int ring, rays, tn, lline, box, trs, res, ent, tot, list, list2, words;
};

__host__ __device__ inline Plan make_plan(int rb, int chunk, bool any,
                                          bool instanced) {
  Plan p;
  int at = 0;
  p.ring = at;  at += chunk * SROW;
  p.rays = at;  at += RAY_ROWS * rb;
  p.tn = at;    at += SCAN_W * rb;
  p.lline = at; at += instanced ? 9 * rb : 0;
  p.box = at;   at += SCAN_W * 8;
  p.trs = at;   at += instanced ? SCAN_W * TRS_COLS : 0;
  p.res = at;   at += any ? rb : (instanced ? 2 * rb : rb);
  p.ent = at;   at += SCAN_W * 4;
  p.tot = at;   at += SCAN_W + 2;       // listed rays; two re-list counts
  p.list = at;  at += SCAN_W * rb / 2;  // uint16 ray ids
  p.list2 = at; at += rb / 2;
  p.words = at;
  return p;
}

// The traversal of one block, closest hit (ANY = false) or any hit.
template <bool ANY, bool INSTANCED, bool COUNT>
__device__ __forceinline__ void traverse(
    const float* __restrict__ rays, const int* __restrict__ wl,
    const float* __restrict__ wtn, const int* __restrict__ cnt,
    const float* __restrict__ boxes, const int* __restrict__ echunk,
    const int* __restrict__ einst, const float* __restrict__ inst_trs,
    const float* __restrict__ tri24, float* __restrict__ best_t,
    int* __restrict__ best_idx, int* __restrict__ best_inst,
    int* __restrict__ occluded, const int* __restrict__ nvalid,
    int* __restrict__ tests, int* __restrict__ xforms, int* __restrict__ ran,
    int ne, int chunk) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool RELIST = RELIST_MODE == 2 || (RELIST_MODE == 1 && ANY);
  const int b = blockIdx.x, tid = threadIdx.x, rb = blockDim.x;
  const int lane = tid & 31;
  const Plan P = make_plan(rb, chunk, ANY, INSTANCED);
  float* const ring = smem + P.ring;
  float* const sray = smem + P.rays;   // rows d m o (0-8), tmin 9, bound 10, f 11
  float* const stn = smem + P.tn;      // (SCAN_W, rb) box-near distance
  float* const lline = smem + P.lline; // (9, rb) local lines
  float* const sbox = smem + P.box;    // (SCAN_W, 8) lo hi pad wtn
  float* const strs = smem + P.trs;    // (SCAN_W, 24) instance rows
  int* const sres = reinterpret_cast<int*>(smem + P.res);
  // Per entry of the group: chunk, instance, triangles, and the listed rays
  // that an earlier entry of the group lists too (their state may change).
  int* const sent = reinterpret_cast<int*>(smem + P.ent);
  int* const stot = reinterpret_cast<int*>(smem + P.tot);  // listed rays
  int* const srelist = stot + SCAN_W;                      // two counters
  unsigned short* const list =
      reinterpret_cast<unsigned short*>(smem + P.list);    // (SCAN_W, rb)
  unsigned short* const list2 =
      reinterpret_cast<unsigned short*>(smem + P.list2);   // (rb,)
  float* const sbound = sray + 10 * rb;  // closest: running best; any: tmax
  int* const sidx = sres;                // closest: best slot
  int* const sinst = sres + rb;          // closest, INSTANCED: its instance
  int* const socc = sres;                // any: occluded flag

  // The owner's view of its ray: what the box tests read, in registers.
  float ox, oy, oz, ix, iy, iz, tmin, rpad;
  bool live;
  {
    const Ray r = load_ray(rays, b, tid, rb);
    sray[0 * rb + tid] = r.w.dx;
    sray[1 * rb + tid] = r.w.dy;
    sray[2 * rb + tid] = r.w.dz;
    sray[3 * rb + tid] = r.w.mx;
    sray[4 * rb + tid] = r.w.my;
    sray[5 * rb + tid] = r.w.mz;
    sray[6 * rb + tid] = r.w.ox;
    sray[7 * rb + tid] = r.w.oy;
    sray[8 * rb + tid] = r.w.oz;
    sray[9 * rb + tid] = r.tmin;
    sbound[tid] = r.tmax;
    sray[11 * rb + tid] = r.f;
    if (ANY) {
      socc[tid] = 0;
    } else {
      sidx[tid] = -1;
      if (INSTANCED) sinst[tid] = -1;
    }
    ox = r.w.ox; oy = r.w.oy; oz = r.w.oz;
    ix = r.ix; iy = r.iy; iz = r.iz;
    tmin = r.tmin;
    rpad = MARGIN * max_abs3(ox, oy, oz);
    // Inactive and padding lanes carry the inverted range [T_FAR, -T_FAR].
    live = r.tmax >= r.tmin;
  }
  int tested = 0, xformed = 0, ranc = 0, kept = 0;
  const int n = cnt[b];
  const int* wlb = wl + (size_t)b * ne;
  const float* wtnb = wtn + (size_t)b * ne;
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += SCAN_W) {
    const int wg = min(SCAN_W, n - k0);
    // -- A. The group's entries: box, chunk, instance, triangle count. ------
    if (tid < wg) {
      const int e = wlb[k0 + tid];
      const float4 lo = reinterpret_cast<const float4*>(boxes)[2 * e];
      const float4 hi = reinterpret_cast<const float4*>(boxes)[2 * e + 1];
      const int c = echunk[e];
      float* bx = sbox + 8 * tid;
      bx[0] = lo.x; bx[1] = lo.y; bx[2] = lo.z;
      bx[3] = lo.w; bx[4] = hi.x; bx[5] = hi.y;
      bx[6] = MARGIN * (1.0f + fmaxf(max_abs3(lo.x, lo.y, lo.z),
                                     max_abs3(lo.w, hi.x, hi.y)));
      bx[7] = wtnb[k0 + tid];
      sent[4 * tid + 0] = c;
      sent[4 * tid + 1] = INSTANCED ? einst[e] : -1;
      sent[4 * tid + 2] = nvalid[c];
      sent[4 * tid + 3] = 0;
      stot[tid] = 0;
      if (tid == 0) srelist[0] = 0;
    }
    __syncthreads();
    if (INSTANCED) {
      for (int i = tid; i < wg * TRS_COLS; i += rb) {
        const int j = i / TRS_COLS, inst = sent[4 * j + 1];
        if (inst >= 0) {
          strs[i] = inst_trs[(size_t)inst * TRS_COLS + (i - j * TRS_COLS)];
        }
      }
    }
    // -- B. Every owner against every box of the group; ray lists. ----------
    // `upper` is the ray's bound now; it may shrink before a later entry of
    // the group is tested, which the items re-check.
    const float upper = sbound[tid];
    const bool open = ANY ? (live && socc[tid] == 0) : live;
    unsigned mymask = 0;
    for (int j = 0; j < wg; ++j) {
      const float* bx = sbox + 8 * j;
      float tn;
      const bool mine = open && box_near(bx, bx[6] + rpad, ox, oy, oz, ix,
                                         iy, iz, tmin, upper, tn);
      if (COUNT) {
        float tx;
        if (mine && !box_near(bx, 0.0f, ox, oy, oz, ix, iy, iz, tmin, upper,
                              tx)) {
          ++kept;
        }
      }
      const unsigned vote = __ballot_sync(FULL, mine);
      const unsigned again =
          RELIST ? __ballot_sync(FULL, mine && mymask != 0u) : 0u;
      if (mine) {
        int base = 0;
        const int leader = __ffs(vote) - 1;
        if (lane == leader) {
          base = atomicAdd(&stot[j], __popc(vote));
          if (again != 0u) atomicAdd(&sent[4 * j + 3], __popc(again));
        }
        base = __shfl_sync(vote, base, leader);
        list[j * rb + base + __popc(vote & ((1u << lane) - 1u))] =
            static_cast<unsigned short>(tid);
        stn[j * rb + tid] = tn;
        mymask |= 1u << j;
      }
    }
    // Near-sorted suffix break: the group's first entry (and every later
    // one) starts beyond every ray's bound, or no ray is open any more.
    if (__syncthreads_and(!open || sbox[7] > upper)) break;

    // -- C. The listed entries, two barriers each. ---------------------------
    int rel = 0;
    for (int jn = 0; jn < wg; ++jn) {
      int nl = stot[jn];
      if (nl == 0) continue;
      const int c = sent[4 * jn], inst = sent[4 * jn + 1];
      const int nv = sent[4 * jn + 2];
      // While the chunk's rows are on their way: the entry's ray list once
      // more where that frees sub-lanes, and the listed rays' local lines.
      copy_chunk(ring, tri24, c, chunk, nv);
      cp_async_commit();
      const unsigned short* lst = list + jn * rb;
      int sh = 0;  // G = 1 << sh
      while (sh < 5 && ((2 * nl) << sh) <= rb && (1 << sh) < nv) ++sh;
      // Rays listed for an earlier entry of the group too may be done by
      // now. If the list without them would give each ray more sub-lanes,
      // keep only the rays that still need this entry.
      const bool relist = RELIST && sh < 5 && (1 << sh) < nv &&
                          ((2 * (nl - sent[4 * jn + 3])) << sh) <= rb;
      if (relist) {
        bool keep = false;
        int r = 0;
        if (tid < nl) {
          r = lst[tid];
          keep = ANY ? socc[r] == 0 : stn[jn * rb + r] <= sbound[r];
        }
        const unsigned vote = __ballot_sync(FULL, keep);
        if (keep) {
          int base = 0;
          const int leader = __ffs(vote) - 1;
          if (lane == leader) base = atomicAdd(&srelist[rel], __popc(vote));
          base = __shfl_sync(vote, base, leader);
          list2[base + __popc(vote & ((1u << lane) - 1u))] =
              static_cast<unsigned short>(r);
        }
      }
      if (INSTANCED && inst >= 0 && ((mymask >> jn) & 1u) &&
          (ANY ? socc[tid] == 0 : stn[jn * rb + tid] <= sbound[tid])) {
        Line w;
        w.dx = sray[0 * rb + tid]; w.dy = sray[1 * rb + tid];
        w.dz = sray[2 * rb + tid]; w.mx = sray[3 * rb + tid];
        w.my = sray[4 * rb + tid]; w.mz = sray[5 * rb + tid];
        w.ox = ox; w.oy = oy; w.oz = oz;
        const Line l =
            xform_ray(strs + TRS_COLS * jn, w, sray[11 * rb + tid]);
        float* o = lline + tid;
        o[0 * rb] = l.dx; o[1 * rb] = l.dy; o[2 * rb] = l.dz;
        o[3 * rb] = l.mx; o[4 * rb] = l.my; o[5 * rb] = l.mz;
        o[6 * rb] = l.ox; o[7 * rb] = l.oy; o[8 * rb] = l.oz;
      }
      cp_async_wait_all();
      __syncthreads();
      if (relist) {
        nl = srelist[rel];
        lst = list2;
        rel ^= 1;
        if (tid == 0) srelist[rel] = 0;
        sh = 0;
        while (sh < 5 && ((2 * nl) << sh) <= rb && (1 << sh) < nv) ++sh;
      }
      // -- Items of entry jn: (listed ray, sub-lane g of G). ----------------
      const int G = 1 << sh, g = tid & (G - 1), li = tid >> sh;
      const float4* T = reinterpret_cast<const float4*>(ring);
      bool act = li < nl;
      const int rid = act ? lst[li] : 0;
      const float bound = sbound[rid];
      const float rtmin = sray[9 * rb + rid];
      // The bound may have shrunk since the scan (closest hit), or the ray
      // found its occluder in an earlier entry of the group (any hit).
      act = act && (ANY ? socc[rid] == 0 : stn[jn * rb + rid] <= bound);
      const float* lsrc = (INSTANCED && inst >= 0)
                              ? lline + rid
                              : sray + rid;
      Line l;
      l.dx = lsrc[0 * rb]; l.dy = lsrc[1 * rb]; l.dz = lsrc[2 * rb];
      l.mx = lsrc[3 * rb]; l.my = lsrc[4 * rb]; l.mz = lsrc[5 * rb];
      l.ox = lsrc[6 * rb]; l.oy = lsrc[7 * rb]; l.oz = lsrc[8 * rb];
      // The needed work, by the exact predicate under the bound now: what
      // the first version counted.
      bool needed = false;
      if (COUNT && act && g == 0) {
        float tx;
        needed = box_near(sbox + 8 * jn, 0.0f, sray[6 * rb + rid],
                          sray[7 * rb + rid], sray[8 * rb + rid],
                          safe_inv(sray[0 * rb + rid]),
                          safe_inv(sray[1 * rb + rid]),
                          safe_inv(sray[2 * rb + rid]), rtmin, bound, tx);
        if (needed && inst >= 0) ++xformed;
      }
      if (!ANY) {
        float cbest = bound;
        int cslot = -1;
        if (act) {
          for (int s = g; s < nv; s += G) {
            const Terms p = plucker(T + s * 7, l);
            const bool ok = fabsf(p.den) > 1e-12f;
            const float tt = p.num / (ok ? p.den : 1.0f);
            if (COUNT) ++ranc;
            // Strict < keeps the first slot on a tie, as argmin does.
            if (p.through && ok && tt >= rtmin && tt < cbest) {
              cbest = tt;
              cslot = s;
            }
          }
        }
        // Smallest t over the G sub-lanes; on equal t the lowest slot.
        for (int off = G >> 1; off > 0; off >>= 1) {
          const float ot = __shfl_xor_sync(FULL, cbest, off);
          const int os = __shfl_xor_sync(FULL, cslot, off);
          if (os >= 0 &&
              (cslot < 0 || ot < cbest || (ot == cbest && os < cslot))) {
            cbest = ot;
            cslot = os;
          }
        }
        if (act && g == 0) {
          if (cslot >= 0) {
            sbound[rid] = cbest;
            sidx[rid] = c * chunk + cslot;
            if (INSTANCED) sinst[rid] = inst;
          }
          if (COUNT && needed) tested += nv;
        }
      } else {
        const float rtmax = bound;
        const unsigned gmask = G == 32 ? FULL : (1u << G) - 1u;
        const int gshift = lane & ~(G - 1);
        const int iters = (nv + G - 1) >> sh;
        int first = -1;
        for (int it = 0; it < iters; ++it) {
          const int s = g + (it << sh);
          bool h = false;
          if (act && s < nv) {
            const Terms p = plucker(T + s * 7, l);
            // Divide-free range test: t = num/den lies in [tmin, tmax] iff
            // (num - tmin*den) and (num - tmax*den) differ in sign.
            const float lo = p.num - rtmin * p.den;
            const float hi = p.num - rtmax * p.den;
            h = p.through && lo * hi <= 0.0f && fabsf(p.den) > 1e-12f;
            if (COUNT) ++ranc;
          }
          const unsigned grp = (__ballot_sync(FULL, h) >> gshift) & gmask;
          if (grp != 0u) {
            // The first hit in slot order: lower slots were tested in
            // earlier rounds or by lower sub-lanes of this one.
            first = (it << sh) + __ffs(grp) - 1;
            act = false;
          }
          if (!__any_sync(FULL, act)) break;
        }
        if (g == 0) {
          if (first >= 0) socc[rid] = 1;
          if (COUNT && needed) tested += first >= 0 ? first + 1 : nv;
        }
      }
      __syncthreads();  // the next entry reads these results and reuses
                        // the chunk table, the local lines and `list2`
    }
  }

  const size_t o = (size_t)b * rb + tid;
  if (ANY) {
    occluded[o] = socc[tid];
  } else {
    best_t[o] = sbound[tid];
    best_idx[o] = sidx[tid];
    best_inst[o] = INSTANCED ? sinst[tid] : -1;
  }
  if (COUNT) {
    block_total(tests, 1, tested);
    block_total(xforms, 1, xformed);
    block_total(ran, 2, ranc);
    block_total(ran == nullptr ? nullptr : ran + 1, 2, kept);
  }
}

template <bool INSTANCED, bool COUNT>
__global__ void __launch_bounds__(MAX_RB, MIN_BLOCKS) closest_hit_kernel(
    const float* __restrict__ rays, const int* __restrict__ wl,
    const float* __restrict__ wtn, const int* __restrict__ cnt,
    const float* __restrict__ boxes, const int* __restrict__ echunk,
    const int* __restrict__ einst, const float* __restrict__ inst_trs,
    const float* __restrict__ tri24, float* __restrict__ best_t,
    int* __restrict__ best_idx, int* __restrict__ best_inst,
    const int* __restrict__ nvalid, int* __restrict__ tests,
    int* __restrict__ xforms, int* __restrict__ ran, int ne, int chunk) {
  traverse<false, INSTANCED, COUNT>(rays, wl, wtn, cnt, boxes, echunk, einst,
                                    inst_trs, tri24, best_t, best_idx,
                                    best_inst, nullptr, nvalid, tests, xforms,
                                    ran, ne, chunk);
}

template <bool INSTANCED, bool COUNT>
__global__ void __launch_bounds__(MAX_RB, MIN_BLOCKS) any_hit_kernel(
    const float* __restrict__ rays, const int* __restrict__ wl,
    const float* __restrict__ wtn, const int* __restrict__ cnt,
    const float* __restrict__ boxes, const int* __restrict__ echunk,
    const int* __restrict__ einst, const float* __restrict__ inst_trs,
    const float* __restrict__ tri24, int* __restrict__ occluded,
    const int* __restrict__ nvalid, int* __restrict__ tests,
    int* __restrict__ xforms, int* __restrict__ ran, int ne, int chunk) {
  traverse<true, INSTANCED, COUNT>(rays, wl, wtn, cnt, boxes, echunk, einst,
                                   inst_trs, tri24, nullptr, nullptr, nullptr,
                                   occluded, nvalid, tests, xforms, ran, ne,
                                   chunk);
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

// ---------------------------------------------------------------------------
// The worklist build of a cast (`prepare_cast`, accel/traverse.py).
//
// It replaces no TPU kernel: the JAX package builds the same worklists with
// jnp in slr_tpu/accel/pallas_intersect.py's wrappers (`_ray_ranges`,
// `_scene_exit_clamp`, `_pack_rays`, `_chunk_worklist`), and the port's plain
// version is the same four tensor functions, which run for CPU tensors. On
// the card those ran ~100 tensor operations a cast and made (NB, NE, RB)
// slab-test tensors with ~30 passes over them: ~15-20 GB of traffic to
// produce NB x NE worklist entries.
//
// What bounds it on an H100: bytes. A ray's origin, direction and range are
// read (~32 B) and its packed column (64 B) and tmax written, ~96 B a ray,
// plus the worklists (8 B an entry a block); the NE slab tests of a ray are
// ~25 fp32 operations each, well under the byte time for the tables the
// renderers cast against.
//
// What the design does about it: one launch, one block per ray block of RB
// lanes, one owner thread per ray. A block
//  1. reduces the union of the valid entry boxes (min and max with NaN
//     propagating, as `amin` / `amax`: exact in any order);
//  2. has each owner read its ray once, derive its range, clamp tmax at the
//     scene exit, write its packed column (coalesced over the block) and
//     keep in registers what the slab tests read;
//  3. stages the entry boxes WL_TILE at a time in shared memory; per entry
//     each warp takes the smallest near distance of its rays that pass the
//     slab test (one integer minimum over the distances' ordered bits,
//     +inf where none passes), and the warps' partials are combined in
//     shared memory into the block's key (its near distance, +inf where no
//     ray of the block meets the entry). The slab tests are most of the
//     kernel's instructions: a warp of finite rays against a box with
//     finite faces takes fminf / fmaxf, equal there to the NaN-propagating
//     minimum and maximum that every other (warp, box) takes, and a warp
//     of inactive lanes skips the boxes that no such lane can pass (most
//     warps, once the wavefront's paths have ended);
//  4. sorts the keys by (key, entry) with a bitonic sort, in the first
//     warp's registers up to 32 entries and in shared memory above (the
//     order of `torch.sort(stable=True)`), and writes the clamped near
//     distances, the count and the worklist, entries past the count
//     repeating the last listed one (entry order[0] where none is listed).
// Above WL_MAX_SORT entries a block's keys do not fit shared memory; the
// kernel then writes the keys and counts and the wrapper sorts them with
// the tensor code (sort_n = 0).
//
// Every value equals the tensor functions' on the same CUDA tensors: the
// build has no FMA contraction, the reciprocal is an IEEE division, and
// min, max and clamp propagate NaN as torch.minimum / maximum / amin / amax /
// clamp do (fminf / fmaxf would drop it).

constexpr int WL_TILE = 64;         // entry boxes staged at a time
constexpr int WL_MAX_SORT = 16384;  // the most entries a block sorts itself

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// A float's bits as an unsigned that orders as the float does (+0 above
// -0), for the warps' integer minimum; and back.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The slab test of `_chunk_worklist` for one ray and one entry box (A, B:
// lo.xyz hi.x | hi.yz flag finite): tn <= tf, tf >= tmin, tn <= tmax, and
// the box nonempty. EXACT takes the NaN-propagating minimum and maximum.
template <bool EXACT>
__device__ __forceinline__ bool slab(float4 A, float4 B, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float tmin, float tmax, float& tn) {
  const auto lo = [](float a, float b) {
    return EXACT ? nan_min(a, b) : fminf(a, b);
  };
  const auto hi = [](float a, float b) {
    return EXACT ? nan_max(a, b) : fmaxf(a, b);
  };
  float t0 = (A.x - ox) * ix, t1 = (A.w - ox) * ix;
  tn = hi(-T_FAR, lo(t0, t1));
  float tf = lo(T_FAR, hi(t0, t1));
  t0 = (A.y - oy) * iy;
  t1 = (B.x - oy) * iy;
  tn = hi(tn, lo(t0, t1));
  tf = lo(tf, hi(t0, t1));
  t0 = (A.z - oz) * iz;
  t1 = (B.y - oz) * iz;
  tn = hi(tn, lo(t0, t1));
  tf = lo(tf, hi(t0, t1));
  return tn <= tf && tf >= tmin && tn <= tmax && B.z > 0.5f;
}

__global__ void __launch_bounds__(MAX_RB) worklist_kernel(
    const float* __restrict__ o, const float* __restrict__ d, int r,
    const float* __restrict__ tmin, long long tmin_step, float tmin_s,
    const float* __restrict__ tmax, long long tmax_step, float tmax_s,
    const unsigned char* __restrict__ active, long long active_step,
    const float* __restrict__ f, long long f_step,
    const float* __restrict__ boxes, int ne, int sort_n,
    float* __restrict__ rays, float* __restrict__ tmax_out,
    int* __restrict__ wl, int* __restrict__ cnt, float* __restrict__ near,
    float* __restrict__ keys) {
  extern __shared__ __align__(16) float wsm[];
  __shared__ float sunion[6];
  __shared__ int scount;
  const float INF = __int_as_float(0x7f800000);
  const int b = blockIdx.x, t = threadIdx.x, rb = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nwarps = rb >> 5;
  float* const sbox = wsm;                           // (WL_TILE, 8)
  float* const spart = sbox + WL_TILE * 8;           // (nwarps, WL_TILE)
  float* const skey = spart + nwarps * WL_TILE;      // (sort_n,)
  int* const sidx = reinterpret_cast<int*>(skey + sort_n);

  // 1. The union of the valid entry boxes ([T_FAR, -T_FAR] where none is),
  // by the first warp.
  if (warp == 0) {
    float u[6] = {T_FAR, T_FAR, T_FAR, -T_FAR, -T_FAR, -T_FAR};
    for (int e = lane; e < ne; e += 32) {
      const float* bx = boxes + (size_t)e * 8;
      const bool valid = bx[6] > 0.5f;
      for (int a = 0; a < 3; ++a) {
        u[a] = nan_min(u[a], valid ? bx[a] : T_FAR);
        u[3 + a] = nan_max(u[3 + a], valid ? bx[3 + a] : -T_FAR);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      for (int a = 0; a < 3; ++a) {
        u[a] = nan_min(u[a], __shfl_xor_sync(FULL, u[a], off));
        u[3 + a] = nan_max(u[3 + a], __shfl_xor_sync(FULL, u[3 + a], off));
      }
    }
    if (lane == 0) {
      for (int a = 0; a < 6; ++a) sunion[a] = u[a];
      scount = 0;
    }
  }
  __syncthreads();

  // 2. The owner's ray: range, exit clamp, packed column. Padding lanes are
  // inert: d = (0, 0, 1), range [T_FAR, -T_FAR], row 9 = 0.
  const long long i = (long long)b * rb + t;
  const bool real = i < r;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
  float tmin_a = T_FAR, tmax_a = -T_FAR, fv = 0.0f;
  if (real) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
    const bool act = active == nullptr || active[i * active_step] != 0;
    if (act) {
      tmin_a = tmin == nullptr ? tmin_s : tmin[i * tmin_step];
      tmax_a = nan_min(tmax == nullptr ? tmax_s : tmax[i * tmax_step], T_FAR);
    }
    if (f != nullptr) fv = f[i * f_step];
  }
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  if (real) {
    const float tx = nan_max((sunion[0] - ox) * ix, (sunion[3] - ox) * ix);
    const float ty = nan_max((sunion[1] - oy) * iy, (sunion[4] - oy) * iy);
    const float tz = nan_max((sunion[2] - oz) * iz, (sunion[5] - oz) * iz);
    const float exit_t =
        nan_max(nan_min(nan_min(tx, ty), tz), 0.0f) * 1.0001f + 1e-4f;
    tmax_a = nan_min(tmax_a, exit_t);
    tmax_out[i] = tmax_a;
  }
  {
    float* col = rays + (size_t)b * ROWS * rb + t;
    col[0 * rb] = dx;
    col[1 * rb] = dy;
    col[2 * rb] = dz;
    col[3 * rb] = real ? oy * dz - oz * dy : 0.0f;
    col[4 * rb] = real ? oz * dx - ox * dz : 0.0f;
    col[5 * rb] = real ? ox * dy - oy * dx : 0.0f;
    col[6 * rb] = ox;
    col[7 * rb] = oy;
    col[8 * rb] = oz;
    col[9 * rb] = real ? 1.0f : 0.0f;
    col[10 * rb] = tmin_a;
    col[11 * rb] = tmax_a;
    col[12 * rb] = fv;
    col[13 * rb] = 0.0f;
    col[14 * rb] = 0.0f;
    col[15 * rb] = 0.0f;
  }

  // 3. Slab tests, reduced per entry over the block into its key. A warp
  // whose rays are all finite takes plain fminf / fmaxf on a box with
  // finite faces: no operand there is NaN, so they equal the NaN-
  // propagating ones; any other (warp, box) takes those.
  // A warp whose rays all have tmax <= -T_FAR (inactive and padding lanes)
  // and are finite skips a box whose every slab distance on some axis of
  // each ray lies within (-T_FAR, T_FAR): there tn > -T_FAR >= tmax, so no
  // ray passes. On the axis of a ray's smallest |1/d| a distance is at most
  // (the box's largest |coordinate| + the ray's) x that |1/d|.
  const bool finite = isfinite(ox) && isfinite(oy) && isfinite(oz) &&
                      isfinite(dx) && isfinite(dy) && isfinite(dz);
  const bool warp_fast = __all_sync(FULL, finite);
  const bool warp_dead = __all_sync(FULL, finite && tmax_a <= -T_FAR);
  const float warp_omax = __uint_as_float(__reduce_max_sync(
      FULL, __float_as_uint(fmaxf(fabsf(ox), fmaxf(fabsf(oy), fabsf(oz))))));
  const float warp_imin = __uint_as_float(__reduce_max_sync(
      FULL, __float_as_uint(fminf(fabsf(ix), fminf(fabsf(iy), fabsf(iz))))));
  const float4* const sbox4 = reinterpret_cast<const float4*>(sbox);
  unsigned* const upart = reinterpret_cast<unsigned*>(spart);
  int listed = 0;
  for (int e0 = 0; e0 < ne; e0 += WL_TILE) {
    const int n = min(WL_TILE, ne - e0);
    for (int k = t; k < n * 8; k += rb) sbox[k] = boxes[(size_t)e0 * 8 + k];
    __syncthreads();
    if (t < n) {  // column 7 (padding) <- the largest |coordinate|, or
      float* bx = sbox + t * 8;  // +inf where a face is not finite
      float m = 0.0f;
      bool fin = true;
      for (int a = 0; a < 6; ++a) {
        fin = fin && isfinite(bx[a]);
        m = fmaxf(m, fabsf(bx[a]));
      }
      bx[7] = fin ? m : INF;
    }
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      const float4 A = sbox4[2 * e], B = sbox4[2 * e + 1];
      unsigned v = ordered(INF);  // +inf: no ray passes
      if (!(warp_dead && (B.w + warp_omax) * warp_imin < 1e38f)) {
        float tn;
        const bool ok = warp_fast && B.w < INF
                            ? slab<false>(A, B, ox, oy, oz, ix, iy, iz,
                                          tmin_a, tmax_a, tn)
                            : slab<true>(A, B, ox, oy, oz, ix, iy, iz,
                                         tmin_a, tmax_a, tn);
        // A passing ray's tn is a number <= tmax <= T_FAR.
        v = __reduce_min_sync(FULL, ordered(ok ? tn : INF));
      }
      if (lane == 0) upart[warp * WL_TILE + e] = v;
    }
    __syncthreads();
    for (int e = t; e < n; e += rb) {
      unsigned v = upart[e];
      for (int w = 1; w < nwarps; ++w) v = min(v, upart[w * WL_TILE + e]);
      const float key = unordered(v);
      listed += key < INF;
      if (sort_n > 0) {
        skey[e0 + e] = key;
        sidx[e0 + e] = e0 + e;
      } else {
        keys[(size_t)b * ne + e0 + e] = key;
      }
    }
  }
  if (listed) atomicAdd(&scount, listed);
  __syncthreads();
  const int count = scount;
  if (t == 0) cnt[b] = count;
  if (sort_n == 0) return;

  // 4. Bitonic sort by (key, entry); the padding sorts last. Up to 32
  // entries the first warp sorts them in registers.
  if (sort_n == 32) {
    if (warp == 0) {
      float k = lane < ne ? skey[lane] : INF;
      int e = lane;
      for (int size = 2; size <= 32; size <<= 1) {
        for (int j = size >> 1; j > 0; j >>= 1) {
          const float ko = __shfl_xor_sync(FULL, k, j);
          const int eo = __shfl_xor_sync(FULL, e, j);
          const bool first = ko < k || (ko == k && eo < e);
          // The lower lane of an ascending pair keeps the first.
          if (first == (((lane & j) == 0) == ((lane & size) == 0))) {
            k = ko;
            e = eo;
          }
        }
      }
      skey[lane] = k;
      sidx[lane] = e;
    }
  } else {
    for (int e = ne + t; e < sort_n; e += rb) {
      skey[e] = INF;
      sidx[e] = e;
    }
    for (int k = 2; k <= sort_n; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        __syncthreads();
        for (int q = t; q < sort_n / 2; q += rb) {
          const int lo = 2 * q - (q & (j - 1)), hi = lo + j;
          const float ka = skey[lo], kb = skey[hi];
          const int ia = sidx[lo], ib = sidx[hi];
          const bool after = ka > kb || (ka == kb && ia > ib);
          if (after == ((lo & k) == 0)) {
            skey[lo] = kb;
            skey[hi] = ka;
            sidx[lo] = ib;
            sidx[hi] = ia;
          }
        }
      }
    }
  }
  __syncthreads();
  const int last = sidx[count > 0 ? count - 1 : 0];
  for (int p = t; p < ne; p += rb) {
    near[(size_t)b * ne + p] = fminf(skey[p], T_FAR);
    wl[(size_t)b * ne + p] = p < count ? sidx[p] : last;
  }
}

size_t worklist_bytes(int rb, int sort_n) {
  return sizeof(float) * ((size_t)WL_TILE * 8 + (size_t)(rb / 32) * WL_TILE) +
         (sizeof(float) + sizeof(int)) * (size_t)sort_n;
}

// A traversal kernel needs more than 48 KB of shared memory, which a
// launch may use only after this attribute is set.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

size_t plan_bytes(int rb, int chunk, bool any, bool instanced) {
  return sizeof(float) * make_plan(rb, chunk, any, instanced).words;
}

bool bad_shape(int rb, int chunk) {
  return rb < 32 || rb > MAX_RB || rb % 32 != 0 || chunk < 1 ||
         chunk > MAX_CHUNK;
}

// [registers, static shared bytes, local (spill) bytes, dynamic shared
// bytes, resident blocks per SM] of one instantiation at this launch shape.
template <typename K>
cudaError_t describe(K kernel, int rb, size_t bytes, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, rb,
                                                      bytes);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(bytes);
  out[4] = blocks;
  return err;
}

}  // namespace

extern "C" {

// Both traversal entry points take, after the stream, `ran` (NB, 2) int32
// or null, and whether the table has an instanced entry.
int slr_closest_hit(const float* rays, const int* wl, const float* wtn,
                    const int* cnt, const float* boxes, const int* echunk,
                    const int* einst, const float* inst_trs,
                    const float* tri24, float* best_t, int* best_idx,
                    int* best_inst, const int* nvalid, int* tests,
                    int* xforms, int nb, int rb, int ne, int chunk,
                    void* stream, int* ran, int instanced) {
  if (bad_shape(rb, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  const bool count = tests != nullptr || xforms != nullptr || ran != nullptr;
  const size_t bytes = plan_bytes(rb, chunk, false, instanced != 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SLR_LAUNCH(I, C)                                                      \
  do {                                                                        \
    cudaError_t err = allow_smem(closest_hit_kernel<I, C>, bytes);            \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    closest_hit_kernel<I, C><<<nb, rb, bytes, st>>>(                          \
        rays, wl, wtn, cnt, boxes, echunk, einst, inst_trs, tri24, best_t,    \
        best_idx, best_inst, nvalid, tests, xforms, ran, ne, chunk);          \
  } while (0)
  if (instanced) {
    if (count) SLR_LAUNCH(true, true); else SLR_LAUNCH(true, false);
  } else {
    if (count) SLR_LAUNCH(false, true); else SLR_LAUNCH(false, false);
  }
#undef SLR_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

int slr_any_hit(const float* rays, const int* wl, const float* wtn,
                const int* cnt, const float* boxes, const int* echunk,
                const int* einst, const float* inst_trs, const float* tri24,
                int* occluded, const int* nvalid, int* tests, int* xforms,
                int nb, int rb, int ne, int chunk, void* stream, int* ran,
                int instanced) {
  if (bad_shape(rb, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  const bool count = tests != nullptr || xforms != nullptr || ran != nullptr;
  const size_t bytes = plan_bytes(rb, chunk, true, instanced != 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SLR_LAUNCH(I, C)                                                      \
  do {                                                                        \
    cudaError_t err = allow_smem(any_hit_kernel<I, C>, bytes);                \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    any_hit_kernel<I, C><<<nb, rb, bytes, st>>>(                              \
        rays, wl, wtn, cnt, boxes, echunk, einst, inst_trs, tri24, occluded,  \
        nvalid, tests, xforms, ran, ne, chunk);                               \
  } while (0)
  if (instanced) {
    if (count) SLR_LAUNCH(true, true); else SLR_LAUNCH(true, false);
  } else {
    if (count) SLR_LAUNCH(false, true); else SLR_LAUNCH(false, false);
  }
#undef SLR_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// out[8][5]: for closest hit then any hit, each (instanced, count) in the
// order (0,0) (0,1) (1,0) (1,1), the five numbers of `describe`.
int slr_traverse_info(int rb, int chunk, int* out) {
  if (bad_shape(rb, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  const size_t cs = plan_bytes(rb, chunk, false, false);
  const size_t ci = plan_bytes(rb, chunk, false, true);
  const size_t as = plan_bytes(rb, chunk, true, false);
  const size_t ai = plan_bytes(rb, chunk, true, true);
#define SLR_INFO(K, I, C, B, AT)                                              \
  if (err == cudaSuccess) err = describe(K<I, C>, rb, B, out + 5 * (AT))
  SLR_INFO(closest_hit_kernel, false, false, cs, 0);
  SLR_INFO(closest_hit_kernel, false, true, cs, 1);
  SLR_INFO(closest_hit_kernel, true, false, ci, 2);
  SLR_INFO(closest_hit_kernel, true, true, ci, 3);
  SLR_INFO(any_hit_kernel, false, false, as, 4);
  SLR_INFO(any_hit_kernel, false, true, as, 5);
  SLR_INFO(any_hit_kernel, true, false, ai, 6);
  SLR_INFO(any_hit_kernel, true, true, ai, 7);
#undef SLR_INFO
  return static_cast<int>(err);
}

int slr_xform_rays(const float* rays, const float* trs_rows, float* out,
                   int nb, int rb, void* stream) {
  if (nb > 0) {
    xform_rays_kernel<<<nb, rb, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, trs_rows, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The worklist build of one cast (see worklist_kernel). tmin, tmax, active
// and f are per-ray with the given element steps (0: one value for all), or
// null: tmin_s / tmax_s for all rays, every ray active, f = 0. sort_n is a
// power of two >= max(ne, 32) and <= WL_MAX_SORT, or 0: then `keys`
// (NB, NE) and `cnt` are written, and not `wl` and `near`.
int slr_build_worklists(const float* o, const float* d, const float* tmin,
                        const float* tmax, const unsigned char* active,
                        const float* f, const float* boxes, float* rays,
                        float* tmax_out, int* wl, int* cnt, float* near,
                        float* keys, long long tmin_step, long long tmax_step,
                        long long active_step, long long f_step, float tmin_s,
                        float tmax_s, int r, int nb, int rb, int ne,
                        int sort_n, void* stream) {
  if (rb < 32 || rb > MAX_RB || rb % 32 != 0 || ne < 1 || sort_n < 0 ||
      sort_n > WL_MAX_SORT || (sort_n & (sort_n - 1)) != 0 ||
      (sort_n > 0 && (sort_n < ne || sort_n < 32))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  const size_t bytes = worklist_bytes(rb, sort_n);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        worklist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  worklist_kernel<<<nb, rb, bytes, static_cast<cudaStream_t>(stream)>>>(
      o, d, r, tmin, tmin_step, tmin_s, tmax, tmax_step, tmax_s, active,
      active_step, f, f_step, boxes, ne, sort_n, rays, tmax_out, wl, cnt,
      near, keys);
  return static_cast<int>(cudaGetLastError());
}

const char* slr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
