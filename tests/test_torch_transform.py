"""core/transform.py of the port against slr_tpu's, function by function,
on the same seeded numpy inputs: the host side (numpy in both packages)
exactly, the device side to atol 1e-6 (f32 sin / acos / sqrt of two
frameworks)."""
import numpy as np
import pytest
import torch

from slr_tpu.core import transform as ref
from slr_tpu_torch.core import transform as port

torch.set_num_threads(1)

N = 257


def _rot(axis, ang):
    c, s = np.cos(ang), np.sin(ang)
    m = np.eye(4)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def _matrices(seed, n=24):
    """Products of translate, rotate and scale; every third one mirrored
    (negative determinant), every fourth with a rotation past 120 degrees
    (the branch of the quaternion extraction without a positive trace)."""
    rs = np.random.RandomState(seed)
    out = []
    for k in range(n):
        m = np.eye(4)
        m[:3, 3] = rs.uniform(-2, 2, 3)
        ang = rs.uniform(2.2, 3.1) if k % 4 == 3 else rs.uniform(-1, 1)
        r = _rot(k % 3, ang) @ _rot((k + 1) % 3, rs.uniform(-0.5, 0.5))
        s = np.diag(np.append(rs.uniform(0.5, 2.0, 3), 1.0))
        if k % 3 == 2:
            s[0, 0] = -s[0, 0]
        out.append((m @ r @ s).astype(np.float32))
    return out


def _quats(seed, n=N):
    rs = np.random.RandomState(seed)
    q = rs.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _trs_batch(seed):
    rs = np.random.RandomState(seed)
    q0 = _quats(seed + 1)
    q1 = _quats(seed + 2)
    q1[::5] = q0[::5]                      # identical: the lerp branch
    q1[1::5] = -q0[1::5]                   # antipodal: flip, then lerp
    small = 1e-3 * rs.normal(size=(N, 4)).astype(np.float32)
    q1[2::5] = q0[2::5] + small[2::5]
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    t0, t1 = (rs.uniform(-2, 2, (N, 3)).astype(np.float32) for _ in range(2))
    s0, s1 = (rs.uniform(0.5, 2, (N, 3)).astype(np.float32) for _ in range(2))
    s0[::7, 0] *= -1.0                     # mirrored instances
    s1[::7, 0] *= -1.0
    f = rs.uniform(0, 1, N).astype(np.float32)
    v = rs.normal(size=(N, 3)).astype(np.float32)
    return t0, q0, s0, t1, q1, s1, f, v


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    import jax.numpy as jnp

    return [jnp.asarray(a) for a in arrays]


# -- host side: exact --------------------------------------------------------

def test_decompose_trs_matches_reference_exactly():
    for m in _matrices(0):
        for got, want in zip(port.decompose_trs(m), ref.decompose_trs(m)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_decompose_flips_scale_on_a_mirrored_matrix():
    m = _matrices(0)[2]
    assert np.linalg.det(m[:3, :3]) < 0
    t, q, s = port.decompose_trs(m)
    assert s[0] < 0 and s[1] > 0 and s[2] > 0
    np.testing.assert_allclose(port.trs_to_matrix_np(t, q, s), m, atol=2e-6)


def test_quat_from_matrix_both_branches_match_reference():
    seen = set()
    for m in _matrices(1, 32):
        a = m[:3, :3].astype(np.float64)
        r = a / np.linalg.norm(a, axis=0)[None, :]
        seen.add(bool(np.trace(r) > 0))
        np.testing.assert_array_equal(port._quat_from_matrix(r),
                                      ref._quat_from_matrix(r))
    assert seen == {True, False}


def test_trs_to_matrix_np_matches_reference_exactly():
    for m in _matrices(2):
        t, q, s = ref.decompose_trs(m)
        np.testing.assert_array_equal(port.trs_to_matrix_np(t, q, s),
                                      ref.trs_to_matrix_np(t, q, s))
        np.testing.assert_array_equal(port._quat_to_matrix_np(q),
                                      ref._quat_to_matrix_np(q))


@pytest.mark.parametrize("f", [0.0, 0.25, 1.0])
def test_slerp_np_matches_reference_exactly(f):
    q0, q1 = _quats(3, 40), _quats(4, 40)
    q1[::4] = -q0[::4]
    q1[1::4] = q0[1::4]
    for a, b in zip(q0, q1):
        np.testing.assert_array_equal(port._slerp_np(a, b, f),
                                      ref._slerp_np(a, b, f))


@pytest.mark.parametrize("steps", [1, 16])
def test_motion_bounds_np_matches_reference_exactly(steps):
    ms = _matrices(5)
    lo = np.float32([-0.3, 0.0, -0.1])
    hi = np.float32([0.2, 0.5, 0.4])
    for m0, m1 in zip(ms[::2], ms[1::2]):
        tr0, tr1 = ref.decompose_trs(m0), ref.decompose_trs(m1)
        got = port.motion_bounds_np(lo, hi, tr0, tr1, steps=steps)
        want = ref.motion_bounds_np(lo, hi, tr0, tr1, steps=steps)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# -- device side: atol 1e-6 --------------------------------------------------

def test_quat_slerp_matches_reference():
    _, q0, _, _, q1, _, f, _ = _trs_batch(10)
    got = port.quat_slerp(*_t(q0, q1, f)).numpy()
    want = np.asarray(ref.quat_slerp(*_j(q0, q1, f)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_quat_rotate_and_conj_match_reference():
    _, q0, _, _, _, _, _, v = _trs_batch(11)
    np.testing.assert_allclose(
        port.quat_rotate(*_t(q0, v)).numpy(),
        np.asarray(ref.quat_rotate(*_j(q0, v))), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(port.quat_conj(*_t(q0)).numpy(),
                                  np.asarray(ref.quat_conj(*_j(q0))))
    back = port.quat_rotate(port.quat_conj(torch.as_tensor(q0)),
                            port.quat_rotate(*_t(q0, v)))
    np.testing.assert_allclose(back.numpy(), v, atol=1e-5)


def test_trs_at_matches_reference():
    args = _trs_batch(12)[:7]
    got = port.trs_at(*_t(*args))
    want = ref.trs_at(*_j(*args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("fn", ["trs_apply_point", "trs_apply_vector",
                                "trs_apply_normal", "trs_inv_apply_point",
                                "trs_inv_apply_vector"])
def test_trs_apply_matches_reference(fn):
    t0, q0, s0, _, _, _, _, v = _trs_batch(13)
    got = getattr(port, fn)(*_t(t0, q0, s0, v)).numpy()
    want = np.asarray(getattr(ref, fn)(*_j(t0, q0, s0, v)))
    # Values reach ~10 (|T| <= 2, |S| <= 2, |v| ~ 3): 1e-6 of that scale.
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_inverse_undoes_forward_with_negative_scale():
    t0, q0, s0, _, _, _, _, v = _trs_batch(14)
    T, R, S, V = _t(t0, q0, s0, v)
    assert bool((S[:, 0] < 0).any())
    p = port.trs_inv_apply_point(T, R, S, port.trs_apply_point(T, R, S, V))
    np.testing.assert_allclose(p.numpy(), v, atol=2e-5)
    w = port.trs_inv_apply_vector(T, R, S, port.trs_apply_vector(T, R, S, V))
    np.testing.assert_allclose(w.numpy(), v, atol=2e-5)
