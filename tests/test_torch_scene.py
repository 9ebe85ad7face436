"""Scene tables: the port's own `cornell_box_spheres` against the reference
builder's, leaf by leaf, and the bridge (`from_reference`) round-tripping
every leaf of reference scenes bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from slr_tpu.scene.presets import cornell_box_spheres as ref_cornell
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.graph import (
    MaterialDesc,
    MeshNode,
    SceneDesc,
    Vertex,
    flatten,
)
from slr_tpu_torch.scene.presets import cornell_box_spheres
from test_torch_reference_build import load_reference_sbvh

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_sbvh():
    """Reference tables are built with the SBVH library loaded (see
    test_torch_reference_build.py)."""
    load_reference_sbvh()


_STATIC = ("n_static", "lobe_kinds_present", "has_env", "has_alpha",
           "has_normal_map", "super_boxes_blob", "spectral", "has_checker",
           "has_voronoi", "has_curve", "has_const", "has_image",
           "has_one_minus")


def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return [f.name for f in dataclasses.fields(obj)]
    return list(obj._fields)


def _walk(ref, port, path=""):
    """Yield (path, ref leaf, port leaf) over the reference's fields; the
    port has no Plücker-matmul path or BVH, so those are skipped."""
    for name in _fields(ref):
        if name in ("plucker", "bvh"):
            continue
        r, p = getattr(ref, name), getattr(port, name)
        sub = f"{path}.{name}"
        if r is None:
            assert p is None, sub
        elif dataclasses.is_dataclass(r) or hasattr(r, "_fields"):
            yield from _walk(r, p, sub)
        else:
            yield sub, name, r, p


def _compare(ref, port, exact_float: bool):
    n = 0
    for path, name, r, p in _walk(ref, port):
        n += 1
        if name in _STATIC or (name == "kind" and path.startswith(".camera")):
            assert p == r, path
            continue
        r = np.asarray(r)
        p = p.cpu().numpy()
        assert p.shape == r.shape, path
        if r.dtype.kind in "iub" or exact_float or name == "remap":
            np.testing.assert_array_equal(p, r.astype(p.dtype), err_msg=path)
        else:
            # Both builders run the same numpy host code; only the camera
            # matrix goes through each framework's f32 cos/sin.
            np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-7,
                                       err_msg=path)
    return n


@pytest.mark.parametrize("spectral", [False, True])
def test_port_builder_matches_reference(spectral):
    ref = ref_cornell(sphere_res=8, use_bvh=False, spectral=spectral)
    port = cornell_box_spheres(sphere_res=8, use_bvh=False, spectral=spectral,
                               device="cpu")
    assert _compare(ref, port, exact_float=False) > 40
    assert port.lobe_kinds_present == (1, 3, 4)
    assert port.stex.has_const is False or not spectral


@pytest.mark.parametrize("use_bvh", [False, True])
def test_bridge_round_trips_bit_for_bit(use_bvh):
    ref = ref_cornell(sphere_res=8, use_bvh=use_bvh, spectral=True)
    port = from_reference(ref)
    assert _compare(ref, port, exact_float=True) > 40
    pt = port.pallas_tris
    assert pt.tri24.shape == (pt.n_chunks, pt.chunk, 24)
    assert not pt.instanced


def test_kernel_rows_hold_the_chunk_columns():
    port = cornell_box_spheres(sphere_res=8, device="cpu")
    pt = port.pallas_tris
    c = pt.chunk
    t = pt.tris.numpy()
    k = pt.tri24.numpy()
    np.testing.assert_array_equal(k[:, :, 0:6], t[:, 0:6, 0:c].transpose(0, 2, 1))
    np.testing.assert_array_equal(k[:, :, 12:18],
                                  t[:, 0:6, 2 * c:3 * c].transpose(0, 2, 1))
    np.testing.assert_array_equal(k[:, :, 18:21],
                                  t[:, 0:3, 3 * c:4 * c].transpose(0, 2, 1))
    np.testing.assert_array_equal(k[:, :, 21], t[:, 9, 4 * c:5 * c])
    np.testing.assert_array_equal(-k[:, :, 18:21],
                                  t[:, 6:9, 4 * c:5 * c].transpose(0, 2, 1))


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cornell_box_spheres(sphere_res=4)
    # Scene graphs flatten to CPU tensors; every material kind does now
    # (here the microfacet metal).
    desc = SceneDesc()
    mesh = MeshNode()
    mesh.vertices = [Vertex(np.float32(p), np.float32([0, 0, 1]),
                            np.float32([1, 0, 0]), np.zeros(2, np.float32))
                     for p in ([0, 0, 0], [1, 0, 0], [0, 1, 0])]
    mesh.add_group(_microfacet_metal(), None, None, [(0, 1, 2)])
    desc.root.add_child(mesh)
    flat = flatten(desc)
    assert flat.device.type == "cpu"
    assert flat.lobe_kinds_present == (5,)


def _microfacet_metal():
    from slr_tpu_torch.scene.graph import FTexDesc, SpectrumDesc, STexDesc

    def ior(comp):
        return STexDesc(kind="constant", spectrum=SpectrumDesc(
            kind="library", library_id="Aluminium", library_comp=comp))

    return MaterialDesc(kind="microfacet metal", stex=(ior(0), ior(1)),
                        ftex=(FTexDesc(kind="constant", value=0.2),))
