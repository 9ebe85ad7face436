"""The worklist build of a cast (`prepare_cast`, accel/traverse.py): on CUDA
tensors one launch of the worklist kernel (`build_worklists`), on CPU
tensors its plain version (`prepare_cast_plain`).

The CPU cases hold the plain version to its contract on a hand-made table
(padding lanes, counts, the repeat-last rule) and check that it launches
and counts nothing; they also run the kernel's sorting network, written out
in numpy, against the plain version's stable sort. The `cuda` cases hold
the kernel's five outputs against the plain version run on the same CUDA
tensors, and a whole `render_wavefront` pass against one built with the
plain version; without a card they skip. This file imports no JAX, so on
the card it runs as `python -m pytest --noconftest
tests/test_torch_worklist.py -m cuda`."""
import os
import types

import numpy as np
import pytest
import torch

from slr_tpu_torch.accel import traverse as tv

torch.set_num_threads(1)

T_FAR = np.float32(tv.T_FAR)
PARITY = os.path.join(os.path.dirname(__file__), "parity_scenes",
                      "Cornell_Box_Parity.txt")


def _table(boxes) -> types.SimpleNamespace:
    """What the worklist build reads of a table: its cast boxes."""
    boxes = torch.as_tensor(np.asarray(boxes, np.float32))
    return types.SimpleNamespace(cast_boxes=boxes, n_entries=boxes.shape[0])


def _box(lo, hi, valid=1.0):
    return [*lo, *hi, valid, 0.0]


# -- the plain version (CPU) ---------------------------------------------------

def test_padding_lanes_and_repeat_last_rule():
    """Three blocks of 32 lanes on a hand-made table: rays that meet three
    entries front to back, rays that meet none (their worklist repeats
    entry 0, their near distances are T_FAR), and a last block of 5 rays
    whose 27 padding lanes are inert."""
    pt = _table([_box((-0.5, -0.5, 5.0), (0.5, 0.5, 6.0)),     # 0
                 _box((-9.0, -9.0, -9.0), (9.0, 9.0, 9.0), 0.0),  # 1 empty
                 _box((-0.5, -0.5, 1.0), (0.5, 0.5, 2.0)),     # 2
                 _box((5.0, -0.5, 1.0), (6.0, 0.5, 2.0)),      # 3 aside
                 _box((-0.5, -0.5, 3.0), (0.5, 0.5, 4.0))])    # 4
    r = 32 + 32 + 5
    o = torch.zeros((r, 3))
    o[64:, 2] = 4.0
    d = torch.zeros((r, 3))
    d[:, 2] = 1.0
    d[32:64, 2] = -1.0
    active = torch.ones(r, dtype=torch.bool)
    active[1:32:2] = False
    f = torch.linspace(0.0, 1.0, r)
    tv.reset_launches()
    rays, wl, cnt, wtn, tmax_a = tv.prepare_cast(pt, o, d, 1e-4,
                                                 float("inf"), active, 32, f)
    assert all(v == 0 for v in tv.LAUNCHES.values())
    assert rays.shape == (3, tv.ROWS, 32)
    assert cnt.tolist() == [3, 0, 1]
    wl = wl.reshape(3, 5).tolist()
    wtn = wtn.reshape(3, 5).numpy()
    assert wl == [[2, 4, 0, 0, 0], [0] * 5, [0] * 5]
    np.testing.assert_array_equal(wtn[0], [1.0, 3.0, 5.0, T_FAR, T_FAR])
    np.testing.assert_array_equal(wtn[1], [T_FAR] * 5)
    np.testing.assert_array_equal(wtn[2], [1.0, *[T_FAR] * 4])
    # The exit from the union of the valid boxes (z = 6 along +z), clamped.
    exit_t = np.float32(np.float32(6.0) * np.float32(1.0001)) \
        + np.float32(1e-4)
    lane = rays.transpose(1, 2).reshape(-1, tv.ROWS)
    np.testing.assert_array_equal(tmax_a[0:32:2].numpy(), exit_t)
    np.testing.assert_array_equal(tmax_a[1:32:2].numpy(), -T_FAR)
    np.testing.assert_array_equal(lane[1:32:2, 10].numpy(), T_FAR)
    np.testing.assert_array_equal(lane[:r, 11].numpy(), tmax_a.numpy())
    np.testing.assert_array_equal(lane[:r, 9].numpy(), 1.0)
    np.testing.assert_array_equal(lane[:r, 12].numpy(), f.numpy())
    pad = np.zeros((96 - r, tv.ROWS), np.float32)
    pad[:, 2] = 1.0
    pad[:, 10] = T_FAR
    pad[:, 11] = -T_FAR
    np.testing.assert_array_equal(lane[r:].numpy(), pad)


def test_plain_build_launches_nothing():
    """CPU tensors take the plain version, whatever the table's size: no
    launch is counted, not even past the kernel's sort limit."""
    rs = np.random.RandomState(4)
    ne = tv.WORKLIST_MAX_SORT + 1
    lo = rs.uniform(-1, 1, (ne, 3)).astype(np.float32)
    pt = _table(np.concatenate([lo, lo + 0.05, np.ones((ne, 1)),
                                np.zeros((ne, 1))], 1))
    o = torch.as_tensor(rs.uniform(-0.5, 0.5, (40, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(
        rs.normal(size=(40, 3)).astype(np.float32)), dim=1)
    tv.reset_launches()
    got = tv.prepare_cast(pt, o, d, 1e-4, 2.0, None)
    assert all(v == 0 for v in tv.LAUNCHES.values())
    want = tv.prepare_cast_plain(pt, o, d, 1e-4, 2.0, None, tv._auto_rb(pt))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[2].sum()) > 0


def _bitonic_worklist(key: np.ndarray, count: np.ndarray, warp: bool):
    """csrc/traverse.cu worklist_kernel's step 4, written out in numpy: the
    bitonic network on (key, entry) over the padded width (at least 32),
    pair by pair as in shared memory or lane by lane as in the first warp's
    registers (`warp`, 32 entries), then the clamped near distances and the
    repeat-last rule."""
    nb, ne = key.shape
    n = max(32, 1 << (ne - 1).bit_length())
    k_ = np.full((nb, n), np.inf, np.float32)
    k_[:, :ne] = key
    i_ = np.broadcast_to(np.arange(n), (nb, n)).copy()
    q = np.arange(n // 2)
    lane = np.arange(n)
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            if warp:
                ko, io = k_[:, lane ^ j], i_[:, lane ^ j]
                first = (ko < k_) | ((ko == k_) & (io < i_))
                take = first == (((lane & j) == 0) == ((lane & k) == 0))
                k_, i_ = np.where(take, ko, k_), np.where(take, io, i_)
                j >>= 1
                continue
            lo = 2 * q - (q & (j - 1))
            hi = lo + j
            ka, kb, ia, ib = k_[:, lo], k_[:, hi], i_[:, lo], i_[:, hi]
            after = (ka > kb) | ((ka == kb) & (ia > ib))
            swap = after == ((lo & k) == 0)[None, :]
            k_[:, lo], k_[:, hi] = np.where(swap, kb, ka), np.where(swap, ka, kb)
            i_[:, lo], i_[:, hi] = np.where(swap, ib, ia), np.where(swap, ia, ib)
            j >>= 1
        k <<= 1
    last = i_[np.arange(nb), np.maximum(count - 1, 0)]
    pos = np.arange(ne)[None, :]
    wl = np.where(pos < count[:, None], i_[:, :ne], last[:, None])
    return wl.reshape(-1), np.minimum(k_[:, :ne], T_FAR).reshape(-1)


@pytest.mark.parametrize("ne,warp", [(1, True), (2, True), (31, True),
                                     (32, True), (33, False), (250, False)])
def test_kernel_sort_network_matches_stable_sort(ne, warp):
    """The kernel's sort gives `torch.sort(stable=True)`'s order on keys
    with ties, signed zeros and +inf (entries no ray of the block meets)."""
    rs = np.random.RandomState(ne)
    key = rs.choice(np.float32([-2.5, -0.0, 0.0, 0.75, 3.0, T_FAR]),
                    (64, ne)).astype(np.float32)
    key[rs.rand(64, ne) < 0.4] = np.inf
    key[:3] = np.inf                                  # blocks that meet none
    count = np.isfinite(key).sum(1)
    wl, near = _bitonic_worklist(key, count, warp)
    want_wl, want_near = tv._sorted_worklist(torch.as_tensor(key),
                                             torch.as_tensor(count))
    np.testing.assert_array_equal(wl, want_wl.numpy())
    np.testing.assert_array_equal(near, want_near.numpy())


# -- the kernel (CUDA) ---------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a: torch.Tensor, b: torch.Tensor) -> None:
    """Equal values, NaN where the other has NaN."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b))
        a, b = torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)
    assert torch.equal(a, b)


CASES = {
    # table, rays, active, bounds, shutter fraction, NaN rays
    "cornell": ("cornell", 4096, "mixed", "scalar", False, False),
    "cornell_per_ray_unaligned": ("cornell", 1000, None, "per_ray", False,
                                  False),
    "cornell_all_inactive": ("cornell", 1000, "none", "per_ray", False,
                             False),
    "cornell_fewer_than_a_block": ("cornell", 77, "mixed", "0d", False,
                                   False),
    "cornell_nan": ("cornell", 600, "mixed", "scalar", False, True),
    "grass": ("grass", 3000, None, "scalar", True, False),
    "grass_mixed_nan": ("grass", 1000, "mixed", "per_ray", True, True),
    "huge_boxes_inactive": ("huge", 500, "none", "scalar", False, False),
    "huge_boxes_mixed": ("huge", 500, "mixed", "per_ray", False, True),
    "entries_16384": (16384, 300, "mixed", "per_ray", False, True),
    "entries_16385_tensor_sort": (16385, 300, "mixed", "scalar", False,
                                  False),
}


def _case_table(table, dev):
    if table == "cornell":
        from slr_tpu_torch.scene.api import load_scene

        return load_scene(PARITY, spectral=True, device=dev)[0].pallas_tris
    if table == "grass":
        from slr_tpu_torch.scene.presets import grass_field

        return grass_field(n_side=24, blade_segments=5,
                           animated_fraction=0.25, device=dev).pallas_tris
    # Random boxes; "huge": 40 of them, two spanning [-T_FAR, T_FAR], which
    # even inactive lanes (range [T_FAR, -T_FAR]) pass.
    ne = 40 if table == "huge" else table
    rs = np.random.RandomState(ne)
    lo = rs.uniform(-1, 1, (ne, 3)).astype(np.float32)
    boxes = np.concatenate([lo, lo + rs.uniform(0.01, 0.2, (ne, 3)),
                            (rs.rand(ne, 1) < 0.95), np.zeros((ne, 1))],
                           1).astype(np.float32)
    if table == "huge":
        boxes[[5, 17], 0:3], boxes[[5, 17], 3:7] = -T_FAR, T_FAR
        boxes[[5, 17], 6] = 1.0
    return types.SimpleNamespace(cast_boxes=torch.as_tensor(boxes, device=dev),
                                 n_entries=ne)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_worklist_kernel_matches_plain_version(case):
    """The kernel's rays, worklists, counts, near distances and clamped
    tmax equal the plain version's on the same CUDA tensors."""
    dev = _cuda()
    table, r, active, bounds, with_f, nan = CASES[case]
    pt = _case_table(table, dev)
    rs = np.random.RandomState(len(case))
    o = rs.uniform(-0.9, 0.9, (r, 3)).astype(np.float32)
    d = rs.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if table == "grass":
        o *= 2.0
        o[:, 1] = rs.uniform(0.0, 0.6, r)
    if nan:
        d[::7, rs.randint(0, 3)] = np.nan
        o[3::11, 0] = np.nan
    o, d = (torch.as_tensor(x, device=dev) for x in (o, d))
    act = None
    if active == "mixed":
        act = torch.as_tensor(rs.rand(r) < 0.7, device=dev)
    elif active == "none":
        act = torch.zeros(r, dtype=torch.bool, device=dev)
    tmin, tmax = 1e-4, float("inf")
    if bounds == "per_ray":
        tmin = torch.as_tensor(rs.uniform(0, 0.05, r).astype(np.float32),
                               device=dev)
        tmax = torch.as_tensor(rs.uniform(0.2, 3.0, r).astype(np.float32),
                               device=dev)
    elif bounds == "0d":
        tmax = torch.tensor(0.7, device=dev)
    f = (torch.as_tensor(rs.uniform(0, 1, r).astype(np.float32), device=dev)
         if with_f else None)
    tv.reset_launches()
    got = tv.prepare_cast(pt, o, d, tmin, tmax, act, None, f)
    want = tv.prepare_cast_plain(pt, o, d, tmin, tmax, act, tv._auto_rb(pt),
                                 f)
    torch.cuda.synchronize()
    for name, a, b in zip(("rays", "wl", "cnt", "wtn", "tmax_a"), got, want):
        try:
            _same(a, b)
        except AssertionError as e:
            raise AssertionError(f"{case}: {name} differs") from e
    over = pt.n_entries > tv.WORKLIST_MAX_SORT
    assert tv.LAUNCHES["worklist"] == 1
    assert tv.LAUNCHES["worklist_tensor_sort"] == int(over)
    assert int(got[2].sum()) > 0 or active == "none"


@pytest.mark.cuda
def test_cuda_worklist_kernel_renders_as_the_plain_build(monkeypatch):
    """One `render_wavefront` pass at the benchmark's `cornell_pt` shape
    (the parity scene, 1024x768, 4 spp, depth 100, 1,572,864 lanes) gives
    the same image as the same pass with every worklist built by the plain
    version, and launches the kernel twice an iteration (the closest-hit
    and the shadow cast). Deterministic algorithms make the film's
    `index_add_` sum in a fixed order, so that the two images can be
    compared bit for bit."""
    from slr_tpu_torch.render.wavefront import render_wavefront
    from slr_tpu_torch.scene.api import load_scene

    dev = _cuda()
    scene, _, settings = load_scene(PARITY, spectral=True, device=dev)
    seed = int(settings.get("rngSeed", 0)) & 0xFFFFFFFF

    def render():
        return render_wavefront(scene, 1024, 768, spp=4, seed=seed,
                                max_depth=100, return_iters=True,
                                n_lanes=1572864, device=dev)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        tv.reset_launches()
        img, iters = render()
        assert tv.LAUNCHES["worklist"] == 2 * iters
        assert tv.LAUNCHES["worklist_tensor_sort"] == 0
        monkeypatch.setattr(tv, "build_worklists", tv.prepare_cast_plain)
        img_plain, iters_plain = render()
    finally:
        torch.use_deterministic_algorithms(False)
    assert iters_plain == iters
    assert torch.equal(img, img_plain)
