"""Scene sharding by range over the ranks (counterpart of
slr_tpu/parallel/scene_shard.py).

For scenes whose tables outgrow one device, each rank holds only its
contiguous range of the chunk tables (the dominant memory: a 128-slot
chunk is ~53 KB with its kernel rows), its range of the packed
per-triangle shading rows and its range of the image atlas. Rays are
replicated: every rank casts them against its own chunks, and a
lexicographic (t, rank) reduction picks the closest hit (`all_reduce(MIN)`
on t, `MIN` on the winning rank, then one `SUM` of the winner's fields
packed into one tensor). Shading rows and texels reach every rank the same
way, each rank adding those that fall in its range (`SUM`). Floats travel
as their int32 bit patterns, so every sum of one rank's value and zeros is
exact.

`shard_scene` builds a rank's `SceneShard` from a scene on the host, moving
only the rank's ranges onto its device; the traced scene it hands the path
tracer carries the replicated small tables, the emissive triangles' rows
(light sampling) and a `ShardedAtlas` as its image atlas, so every texel
fetch (spectrum, float and normal textures, the environment, alpha
cutouts) goes through the sharded gather.
"""
from __future__ import annotations

import dataclasses

import torch

from ..accel.intersect import RAY_EPSILON, Hit, moller_trumbore
from ..accel.traverse import (
    T_FAR,
    PallasTris,
    _add_work,
    _work_counters,
    any_hit,
    closest_hit,
    prepare_cast,
)
from ..scene.types import FlatScene, Geometry
from .mesh import Mesh

Tensor = torch.Tensor

_NO_RANK = 1 << 30


def _as_bits(x: Tensor) -> Tensor:
    return x.contiguous().view(torch.int32)


def _from_bits(x: Tensor) -> Tensor:
    return x.contiguous().view(torch.float32)


def shard_chunk_tables(pt: PallasTris, n_shards: int) -> PallasTris:
    """Pad the chunk axis to a multiple of n_shards so every rank gets an
    equal chunk range. Padding chunks are empty (nonempty flag 0) and their
    remap rows are -1. Static tables only: one entry per chunk."""
    if pt.instanced or pt.n_entries != pt.n_chunks:
        raise ValueError("chunk tables with instance entries do not shard "
                         "by range")
    nc = pt.n_chunks
    pad = -(-nc // n_shards) * n_shards - nc
    if pad == 0:
        return pt
    c = pt.chunk
    dev = pt.tris.device
    return PallasTris(
        tris=torch.cat([pt.tris, torch.zeros((pad,) + pt.tris.shape[1:],
                                             device=dev)]),
        boxes=torch.cat([pt.boxes, torch.zeros((pad, 8), device=dev)]),
        remap=torch.cat([pt.remap, torch.full((pad * c,), -1,
                                              dtype=torch.int32,
                                              device=dev)]),
        entry_chunk=torch.arange(nc + pad, dtype=torch.int32, device=dev),
        entry_inst=torch.full((nc + pad,), -1, dtype=torch.int32,
                              device=dev),
        inst_trs=pt.inst_trs)


def shard_image_atlas(images: Tensor, n_shards: int) -> tuple[Tensor, int]:
    """Pad the atlas's image axis to a multiple of n_shards; shard k holds
    images [k*per, (k+1)*per). Returns (images padded, per)."""
    ni = images.shape[0]
    per = max(-(-ni // n_shards), 1)
    pad = n_shards * per - ni
    if pad:
        images = torch.cat([images, torch.zeros(
            (pad,) + images.shape[1:], dtype=images.dtype,
            device=images.device)])
    return images, per


def shard_tri_rows(tri_table: Tensor, n_shards: int) -> tuple[Tensor, int]:
    """Range-shard the packed per-triangle shading table (40 f32 a
    triangle, accel/intersect.py `build_tri_table`): shard k holds rows
    [k*per, (k+1)*per). Returns (rows padded to n_shards*per, per)."""
    t = tri_table.shape[0]
    per = -(-t // n_shards)
    pad = n_shards * per - t
    if pad:
        tri_table = torch.cat([tri_table, torch.zeros(
            (pad, tri_table.shape[1]), dtype=tri_table.dtype,
            device=tri_table.device)])
    return tri_table, per


def gather_tri_rows_sharded(mesh: Mesh, rows_local: Tensor, per: int,
                            tri: Tensor) -> Tensor:
    """The rows of triangles `tri` (R,) (negative: a miss, a zero row) from
    the range-sharded table: each rank holds rows [rank*per, (rank+1)*per)
    and adds those in its range; one `SUM` assembles them."""
    tri = tri.to(torch.int64)
    local = tri - mesh.rank * per
    mine = (tri >= 0) & (local >= 0) & (local < per)
    rows = rows_local[torch.clamp(local, 0, per - 1)]
    rows = torch.where(mine[:, None], rows, 0.0)
    return _from_bits(mesh.all_reduce(_as_bits(rows)))


def fetch_texels_sharded(mesh: Mesh, images_local: Tensor, per: int,
                         ni_total: int, image_hw: Tensor, image_id: Tensor,
                         u: Tensor, v: Tensor) -> Tensor:
    """The atlas's counterpart of `gather_tri_rows_sharded`: each rank
    holds images [rank*per, (rank+1)*per) and adds the texels whose image
    falls in its range. The texel addresses are `textures.texel_coords`',
    so a sharded fetch reads the texels an unsharded one reads."""
    from ..scene.textures import texel_coords

    shp = u.shape
    iid, py, px = texel_coords(image_hw, image_id, u, v, ni_total)
    iid, py, px = iid.reshape(-1), py.reshape(-1), px.reshape(-1)
    local = iid - mesh.rank * per
    mine = (local >= 0) & (local < per)
    rows = images_local[torch.clamp(local, 0, per - 1), py, px]
    rows = torch.where(mine[:, None], rows, 0.0)
    return _from_bits(mesh.all_reduce(_as_bits(rows))).reshape(shp + (4,))


class ShardedAtlas:
    """An image atlas split by image range over the ranks: this rank's
    images and how to fetch any texel. It stands where a scene's
    `stex.images` tensor stands; `textures._image_fetch` calls its
    `fetch`."""

    def __init__(self, mesh: Mesh, images_local: Tensor, per: int,
                 ni_total: int):
        self.mesh = mesh
        self.images_local = images_local
        self.per = per
        self.ni_total = ni_total

    @property
    def shape(self) -> tuple:
        return (self.ni_total,) + tuple(self.images_local.shape[1:])

    @property
    def device(self) -> torch.device:
        return self.images_local.device

    def fetch(self, image_hw: Tensor, image_id: Tensor, u: Tensor,
              v: Tensor) -> Tensor:
        return fetch_texels_sharded(self.mesh, self.images_local, self.per,
                                    self.ni_total, image_hw, image_id, u, v)


def _tensor_bytes(*tensors) -> int:
    seen, n = set(), 0
    for t in tensors:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            n += t.numel() * t.element_size()
    return n


def _chunk_table_bytes(pt: PallasTris, slot_rows: Tensor) -> int:
    return _tensor_bytes(pt.tris, pt.boxes, pt.cast_boxes, pt.remap,
                         pt.entry_chunk, pt.entry_inst, pt.inst_trs, pt.tri24,
                         pt.n_valid, slot_rows)


def _slot_rows(pt: PallasTris, tri_table: Tensor) -> Tensor:
    """Per kernel slot, the vertex columns (p0, e01, e02) of its triangle's
    shading row (zeros for padding): the winning rank computes the hit's
    Möller-Trumbore barycentrics from them, as `intersect_pallas` does from
    the whole table."""
    remap = pt.remap.to(torch.int64)
    rows = tri_table[torch.clamp(remap, min=0), 0:9]
    return torch.where((remap >= 0)[:, None], rows, 0.0).contiguous()


@dataclasses.dataclass
class SceneShard:
    """One rank's part of a range-sharded scene, on the rank's device.

    pt: its chunk range (local entry ids, global triangle ids in `remap`);
    slot_rows: (slots, 9) the vertex columns of each slot's triangle;
    rows / per: its range of the shading rows; scene: the traced scene
    (replicated small tables, the emissive triangles' rows, the atlas);
    bytes / whole_bytes: device bytes of its tables (pallas_tris, tri_rows,
    atlas) and of the unsharded ones, with `chunk_bytes` / `image_bytes`
    one chunk's and one image's share."""

    mesh: Mesh
    pt: PallasTris
    slot_rows: Tensor
    rows: Tensor
    per: int
    scene: FlatScene
    bytes: dict
    whole_bytes: dict
    chunk_bytes: int
    image_bytes: int

    # -- casts -------------------------------------------------------------
    def _cast_closest(self, o: Tensor, d: Tensor, tmin, tmax,
                      active) -> Hit:
        """This rank's closest hit, then the (t, rank) reduction."""
        mesh, pt = self.mesh, self.pt
        r = o.shape[0]
        rays, wl, cnt, wtn, tmax_a = prepare_cast(pt, o, d, tmin, tmax,
                                                  active)
        tests, xforms = _work_counters(rays)
        best_t, best_idx, _ = closest_hit(rays, wl, wtn, cnt, pt, tests,
                                          xforms)
        _add_work(0, tests, xforms)
        best_t = best_t.reshape(-1)[:r]
        slot = torch.clamp(best_idx.reshape(-1)[:r].to(torch.int64), min=0)
        tri = torch.where(best_idx.reshape(-1)[:r] >= 0,
                          pt.remap.to(torch.int64)[slot], -1)
        mask = (tri >= 0) & (best_t < T_FAR) & (best_t < tmax_a * (1.0 + 1e-6))
        sr = self.slot_rows[slot]
        p0 = sr[:, 0:3]
        t_mt, b1, b2, _ = moller_trumbore(o, d, p0, p0 + sr[:, 3:6],
                                          p0 + sr[:, 6:9], 0.0, float("inf"))
        b1 = torch.clamp(b1, 0.0, 1.0)
        b2 = torch.clamp(b2, 0.0, 1.0)

        t_key = torch.where(mask, best_t, float("inf"))
        t_min = mesh.all_reduce(t_key, "min")
        winner = t_key <= t_min
        win_rank = mesh.all_reduce(torch.where(
            winner, mesh.rank, _NO_RANK).to(torch.int32), "min")
        mine = winner & mask & (win_rank == mesh.rank)
        packed = torch.stack([_as_bits(t_mt), _as_bits(b1), _as_bits(b2),
                              _as_bits(best_t), tri.to(torch.int32),
                              mask.to(torch.int32)], dim=1)
        packed = mesh.all_reduce(torch.where(mine[:, None], packed, 0))
        t_mt, b1, b2, t_cast = (_from_bits(packed[:, k]) for k in range(4))
        tri = packed[:, 4].to(torch.int64)
        mask = packed[:, 5] > 0
        inf = float("inf")
        return Hit(t=torch.where(mask, t_mt, inf),
                   tri=torch.where(mask, tri, -1), b0=1.0 - b1 - b2, b1=b1,
                   mask=mask, t_cast=torch.where(mask, t_cast, inf))

    def _with_rows(self, scene: FlatScene, hit: Hit):
        """`scene` whose shading table is the hits' gathered rows (a normal
        map's id rides in them), and the hits numbered into it."""
        rows = gather_tri_rows_sharded(self.mesh, self.rows, self.per,
                                       hit.tri)
        geom = dataclasses.replace(scene.geometry, tri_table=rows)
        if scene.has_normal_map:
            geom.tri_ntex = rows[:, 36].to(torch.int32)
        local = torch.where(hit.tri >= 0,
                            torch.arange(hit.tri.shape[0],
                                         device=rows.device), -1)
        return dataclasses.replace(scene, geometry=geom), hit._replace(
            tri=local)

    def intersect(self, scene, o: Tensor, d: Tensor, tmin=RAY_EPSILON,
                  tmax=float("inf"), f=None, active: Tensor | None = None
                  ) -> Hit:
        """Closest hit honoring alpha cutouts over the sharded tables (the
        signature of render/pt.py `scene_intersect_alpha`; `scene` and `f`
        are not used): its recast loop, with the alpha test reading the
        gathered rows and texels. Every rank holds the same hits, so all
        leave the loop together."""
        from ..render.pt import _alpha_zero, recast_alpha

        hit = self._cast_closest(o, d, tmin, tmax, active)
        if not self.scene.has_alpha:
            return hit
        return recast_alpha(
            hit, tmin, lambda h: _alpha_zero(*self._with_rows(self.scene, h)),
            lambda tmin_b, cut: self._cast_closest(o, d, tmin_b, tmax, cut))

    def occluded(self, scene, o: Tensor, d: Tensor, tmin, tmax, f=None,
                 active: Tensor | None = None) -> Tensor:
        """Occlusion over the sharded tables (the signature of
        `scene_occluded`): any hit on each rank's range, OR-reduced by one
        `SUM`; in a scene with alpha cutouts the closest hit and its
        recasts, so that a cut-out surface casts no shadow."""
        if self.scene.has_alpha:
            return self.intersect(scene, o, d, tmin, tmax, active=active).mask
        return self._cast_any(o, d, tmin, tmax, active)

    def _cast_any(self, o: Tensor, d: Tensor, tmin, tmax, active) -> Tensor:
        """Any hit on this rank's range, OR-reduced over the ranks."""
        r = o.shape[0]
        rays, wl, cnt, wtn, _ = prepare_cast(self.pt, o, d, tmin, tmax,
                                             active)
        tests, xforms = _work_counters(rays)
        occ = any_hit(rays, wl, wtn, cnt, self.pt, tests, xforms)
        _add_work(2, tests, xforms)
        return self.mesh.all_reduce(occ.reshape(-1)[:r]) > 0

    def resolve(self, scene: FlatScene, hit: Hit, o: Tensor, d: Tensor,
                f=None):
        """Surface points of the hits from their gathered shading rows (the
        signature of `resolve_sp`)."""
        from ..render.pt import resolve_sp

        scene, hit = self._with_rows(scene, hit)
        return resolve_sp(scene, hit, o, d, f=f)


def shard_scene(scene: FlatScene, mesh: Mesh) -> SceneShard:
    """This rank's `SceneShard` of `scene` (best kept on the host: only the
    rank's ranges and the small replicated tables are moved to
    `mesh.device`). Static scenes only: instance entries do not partition
    by chunk range."""
    if scene.instances is not None:
        raise ValueError("an instanced scene does not shard by range; "
                         "render_pt_scene_sharded renders it replicated")
    n, k, dev = mesh.size, mesh.rank, mesh.device
    whole = scene.pallas_tris
    tri_table = scene.geometry.tri_table
    padded = shard_chunk_tables(whole, n)
    nc_l = padded.n_chunks // n
    c = padded.chunk
    lo, hi = k * nc_l, (k + 1) * nc_l
    pt = PallasTris(
        tris=padded.tris[lo:hi].to(dev), boxes=padded.boxes[lo:hi].to(dev),
        remap=padded.remap[lo * c:hi * c].to(dev),
        entry_chunk=torch.arange(nc_l, dtype=torch.int32, device=dev),
        entry_inst=torch.full((nc_l,), -1, dtype=torch.int32, device=dev),
        inst_trs=torch.zeros((1, 24), device=dev))
    slot_rows = _slot_rows(padded, tri_table)[lo * c:hi * c].to(dev)
    rows_padded, per = shard_tri_rows(tri_table, n)
    rows = rows_padded[k * per:(k + 1) * per].to(dev)

    images = scene.stex.images
    ni = images.shape[0]
    if ni:
        atlas_padded, per_img = shard_image_atlas(images, n)
        atlas = ShardedAtlas(mesh, atlas_padded[k * per_img:
                                                (k + 1) * per_img].to(dev),
                             per_img, ni)
        local_atlas = atlas.images_local
    else:
        atlas = local_atlas = images.to(dev)

    # The traced scene: no chunk tables, no vertex arrays; light sampling
    # reads the emissive triangles' rows, renumbered.
    g = scene.geometry
    light_tri = scene.lights.tri_idx.to(torch.int64)
    geom = Geometry(positions=g.positions[:0], normals=g.normals[:0],
                    tangents=g.tangents[:0], uvs=g.uvs[:0],
                    tri_vidx=g.tri_vidx[:0], tri_mat=g.tri_mat[:0],
                    tri_alpha=g.tri_alpha[:0], tri_table=tri_table[light_tri])
    lights = dataclasses.replace(
        scene.lights, tri_idx=torch.arange(light_tri.shape[0],
                                           dtype=torch.int32))
    traced = dataclasses.replace(
        scene, geometry=geom, lights=lights,
        stex=dataclasses.replace(scene.stex, images=images[:0]),
        pallas_tris=None, bvh=None, plucker=None).to(dev)
    traced.stex.images = atlas

    chunk_bytes = _chunk_table_bytes(pt, slot_rows) // max(nc_l, 1)
    whole_slots = _slot_rows(whole, tri_table)
    return SceneShard(
        mesh=mesh, pt=pt, slot_rows=slot_rows, rows=rows, per=per,
        scene=traced,
        bytes=dict(pallas_tris=_chunk_table_bytes(pt, slot_rows),
                   tri_rows=_tensor_bytes(rows),
                   atlas=_tensor_bytes(local_atlas)),
        whole_bytes=dict(pallas_tris=_chunk_table_bytes(whole, whole_slots),
                         tri_rows=_tensor_bytes(tri_table),
                         atlas=_tensor_bytes(images)),
        chunk_bytes=chunk_bytes,
        image_bytes=_tensor_bytes(images) // max(ni, 1))


def _shard_of(scene, mesh: Mesh) -> SceneShard:
    return scene if isinstance(scene, SceneShard) else shard_scene(scene,
                                                                    mesh)


def intersect_scene_sharded(scene, mesh: Mesh, o: Tensor, d: Tensor,
                            tmin=None, tmax=None,
                            active: Tensor | None = None) -> Hit:
    """Closest hit with the chunk tables sharded over the ranks. `scene` is
    a `SceneShard` (or a scene on the host, sharded for this call); rays
    are replicated. Exact ties resolve to the lowest rank. The hit carries
    the winner's cast t (`t_cast`)."""
    sh = _shard_of(scene, mesh)
    return sh._cast_closest(o, d, RAY_EPSILON if tmin is None else tmin,
                            float("inf") if tmax is None else tmax, active)


def occluded_scene_sharded(scene, mesh: Mesh, o: Tensor, d: Tensor, tmin,
                           tmax, active: Tensor | None = None) -> Tensor:
    """Occlusion over the sharded chunk tables: each rank runs the any-hit
    cast on its own range, and the results OR-reduce with one `SUM`."""
    return _shard_of(scene, mesh)._cast_any(o, d, tmin, tmax, active)


def render_pt_scene_sharded(scene, mesh: Mesh, width: int, height: int,
                            spp: int, seed: int = 0, max_depth: int = 8,
                            sample_offset: int = 0) -> Tensor:
    """The fixed-depth path tracer (render/pt.py `render`) over a scene
    whose chunk tables, shading rows and image atlas are sharded by range:
    every cast goes through the sharded closest hit (with its alpha
    recasts) or occlusion, every surface point through the row gather,
    every texel through the atlas gather. Returns the (H, W, 3) linear mean
    film on every rank, the estimator of `render` (same random streams).

    An instanced scene renders replicated, through
    `render_wavefront_sharded` (its instance entries do not partition by
    chunk range)."""
    from ..render.pt import render

    if isinstance(scene, FlatScene) and scene.instances is not None:
        from .mesh import render_wavefront_sharded

        return render_wavefront_sharded(scene, width, height, spp, mesh,
                                        seed=seed, max_depth=max_depth,
                                        sample_offset=sample_offset)
    sh = _shard_of(scene, mesh)
    return render(sh.scene, width, height, spp, seed=seed,
                  max_depth=max_depth, sample_offset=sample_offset,
                  device=sh.mesh.device,
                  cast_fns=(sh.intersect, sh.occluded),
                  resolve_fn=sh.resolve)
