"""``utils/camera_paths.py`` against the JAX package's, on seeded poses:
every function within 1e-9 (both are float64 NumPy and SciPy; the port
is the same arithmetic, so the values agree to the bit in practice)."""
import numpy as np
import pytest

from splatfields_torch.utils import camera_paths as tp
from splatfields_tpu.utils import camera_paths as jp

TOL = 1e-9


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    return q * np.sign(np.linalg.det(q))[:, None, None]


def _poses(seed, n):
    rng = np.random.RandomState(seed)
    poses = np.zeros((n, 3, 4))
    poses[:, :, :3] = _rotations(rng, n)
    poses[:, :, 3] = rng.randn(n, 3) * 2
    return poses


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("n,n_interp,kw", [
    (14, 50, dict(spline_degree=3, smoothness=0.0, rot_weight=0.01)),
    (6, 20, {}),                        # the defaults: degree 5, smoothing
    (3, 7, dict(spline_degree=5)),      # the degree capped at n - 1
    (2, 9, {}),                         # two keyframes: a straight line
])
def test_interpolated_path(n, n_interp, kw):
    poses = _poses(n, n)
    got = tp.generate_interpolated_path(poses, n_interp, **kw)
    _close(got, jp.generate_interpolated_path(poses, n_interp, **kw))
    assert got.shape == (n_interp * (n - 1), 3, 4)
    # orientations stay rotations
    rot = got[:, :, :3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-9)


def test_interpolated_path_coinciding_keyframes():
    poses = _poses(1, 4)
    poses[:, :, 3] = 0.5
    _close(tp.generate_interpolated_path(poses, 5),
           jp.generate_interpolated_path(poses, 5))
    with pytest.raises(ValueError):
        tp.generate_interpolated_path(poses[:1], 5)


def test_quaternion_helpers():
    rng = np.random.RandomState(0)
    rots = list(_rotations(rng, 40))
    # trace <= 0 branches: rotations by ~pi about each axis
    rots += [np.diag(d) for d in ([1.0, -1, -1], [-1.0, 1, -1],
                                  [-1.0, -1, 1])]
    for m in rots:
        q = tp._rotmat_to_quat(m)
        _close(q, jp._rotmat_to_quat(m))
        _close(tp._quat_to_rotmat(q), jp._quat_to_rotmat(q))
        _close(tp._quat_to_rotmat(q), m)
    q0, q1 = tp._rotmat_to_quat(rots[0]), tp._rotmat_to_quat(rots[1])
    for u in (0.0, 0.3, 1.0):
        for a, b in ((q0, q1), (q0, -q1), (q0, q0 + 1e-6)):
            b = b / np.linalg.norm(b)
            _close(tp._slerp(a, b, u), jp._slerp(a, b, u))


def test_transform_poses_pca():
    for seed in range(4):
        poses = _poses(seed, 12)
        got, got_t = tp.transform_poses_pca(poses)
        want, want_t = jp.transform_poses_pca(poses)
        _close(got, want)
        _close(got_t, want_t)
        assert np.abs(got[:, :3, 3]).max() == pytest.approx(1.0)


def test_pose_spherical():
    for theta, phi, radius in ((0.0, -30.0, 4.0), (-180.0, 0.0, 3.2),
                               (72.5, 89.9, 1.0), (10.0, 90.0, 2.0)):
        _close(tp.pose_spherical(theta, phi, radius),
               jp.pose_spherical(theta, phi, radius))


def test_rodrigues():
    rng = np.random.RandomState(1)
    for R in _rotations(rng, 20):
        r = tp.rodrigues_mat_to_rot(R)
        _close(r, jp.rodrigues_mat_to_rot(R))
        _close(tp.rodrigues_rot_to_mat(r), jp.rodrigues_rot_to_mat(r))
        _close(tp.rodrigues_rot_to_mat(r), R)
    # the small-angle surrogate and the clipped near-identity case
    for R in (np.eye(3), jp.rodrigues_rot_to_mat(np.array([1e-9, 0, 0])),
              jp.rodrigues_rot_to_mat(np.array([0, np.pi, 0]))):
        _close(tp.rodrigues_mat_to_rot(R), jp.rodrigues_mat_to_rot(R))


def test_render_wander_path():
    rng = np.random.RandomState(2)
    R = _rotations(rng, 1)[0]
    T = rng.randn(3)
    got = tp.render_wander_path(R, T, 0.7, 270, num_frames=12)
    _close(got, jp.render_wander_path(R, T, 0.7, 270, num_frames=12))
    assert got.shape == (12, 4, 4) and got.dtype == np.float32


def test_orbit_camera_matches_jax():
    """``utils/gui.OrbitCamera`` against the JAX package's after the same
    orbit, scale and pan moves: pose, view and intrinsics."""
    from splatfields_torch.utils import gui
    from splatfields_tpu.utils import gui as jax_gui
    cams = [m.OrbitCamera(64, 48, r=2.5, fovy=50.0) for m in (gui, jax_gui)]
    for cam in cams:
        cam.orbit(12.0, -7.0)
        cam.scale(1.5)
        cam.pan(30.0, -4.0, 2.0)
        cam.orbit(-3.0, 5.0)
    for attr in ("pose", "view", "intrinsics"):
        np.testing.assert_array_equal(getattr(cams[0], attr),
                                      getattr(cams[1], attr), err_msg=attr)
