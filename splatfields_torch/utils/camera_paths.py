"""Camera path generation for visualization renders, host NumPy and SciPy
(counterpart of ``splatfields_tpu/utils/camera_paths.py``, function for
function; everything is float64 NumPy and ``scipy.interpolate``).

Capability targets (APIs only — the implementations here are original):
- smooth interpolated fly-through between keyframe poses (the reference
  exposes this via ``utils/camera_utils_multinerf.py:20-66``; we build it
  from a chord-length-parameterized smoothing spline on camera centers plus
  piecewise quaternion slerp on orientations, instead of the multinerf
  pos/lookat/up control-point B-spline),
- PCA recentering of a pose set (``camera_utils_multinerf.py:78-112``
  capability; implemented via SVD of the centered camera-center matrix),
- spherical orbit poses (``utils/pose_utils.py`` capability).

All functions take/return OpenCV-style camera-to-world matrices ``[3, 4]``
(+x right, +y down, +z forward) unless noted.
"""
from __future__ import annotations

import numpy as np
import scipy.interpolate


# ---------------------------------------------------------------------------
# rotation <-> quaternion helpers
# ---------------------------------------------------------------------------

def _rotmat_to_quat(m: np.ndarray) -> np.ndarray:
    """[3, 3] rotation -> unit quaternion (w, x, y, z), Shepperd's method."""
    t = np.trace(m)
    if t > 0:
        r = np.sqrt(1.0 + t)
        w = 0.5 * r
        x = (m[2, 1] - m[1, 2]) / (2 * r)
        y = (m[0, 2] - m[2, 0]) / (2 * r)
        z = (m[1, 0] - m[0, 1]) / (2 * r)
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        r = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        q = np.empty(4)
        q[1 + i] = 0.5 * r
        q[0] = (m[k, j] - m[j, k]) / (2 * r)
        q[1 + j] = (m[j, i] + m[i, j]) / (2 * r)
        q[1 + k] = (m[k, i] + m[i, k]) / (2 * r)
        w, x, y, z = q
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _slerp(q0: np.ndarray, q1: np.ndarray, u: float) -> np.ndarray:
    """Spherical linear interpolation between unit quaternions."""
    dot = float(np.dot(q0, q1))
    if dot < 0.0:  # shortest arc
        q1, dot = -q1, -dot
    if dot > 0.9995:  # nearly parallel: nlerp
        q = (1 - u) * q0 + u * q1
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(dot, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1 - u) * theta) * q0 + np.sin(u * theta) * q1) / s


# ---------------------------------------------------------------------------
# interpolated fly-through
# ---------------------------------------------------------------------------

def generate_interpolated_path(poses, n_interp, spline_degree=5,
                               smoothness=0.03, rot_weight=0.1):
    """Smooth path through ``[n, 3, 4]`` keyframe c2w poses.

    Returns ``[n_interp * (n - 1), 3, 4]`` poses sampled uniformly in the
    chord-length parameter (endpoint excluded, like the reference path).

    Method (original, not the multinerf control-point spline):
    - camera centers follow a smoothing spline of degree
      ``min(spline_degree, n-1)`` with smoothing factor ``smoothness``,
      parameterized by normalized cumulative chord length (so unevenly
      spaced keyframes don't warp the speed);
    - orientations follow piecewise slerp between consecutive keyframe
      quaternions, evaluated in the same parameter.

    ``rot_weight`` is accepted for signature compatibility; orientation
    smoothing here is handled by slerp rather than by offsetting lookat/up
    control points, so it has no effect.
    """
    del rot_weight
    poses = np.asarray(poses, np.float64)
    n = poses.shape[0]
    if n < 2:
        raise ValueError("need at least 2 keyframe poses")
    centers = poses[:, :3, 3]
    quats = [_rotmat_to_quat(p[:3, :3]) for p in poses]
    # keep quaternion signs hemisphere-continuous for clean slerp segments
    for i in range(1, n):
        if np.dot(quats[i - 1], quats[i]) < 0:
            quats[i] = -quats[i]

    # chord-length parameter of the keyframes, normalized to [0, 1]
    seg = np.linalg.norm(np.diff(centers, axis=0), axis=1)
    knots = np.concatenate([[0.0], np.cumsum(seg)])
    if knots[-1] <= 0:  # all keyframes coincide
        knots = np.linspace(0.0, 1.0, n)
    else:
        knots = knots / knots[-1]
    # strictly increasing for the spline: nudge duplicates
    for i in range(1, n):
        if knots[i] <= knots[i - 1]:
            knots[i] = knots[i - 1] + 1e-8

    m = n_interp * (n - 1)
    u = np.linspace(0.0, 1.0, m, endpoint=False)

    k = min(spline_degree, n - 1)
    if k >= 2:
        tck, _ = scipy.interpolate.splprep(
            centers.T, u=knots, k=k, s=smoothness)
        pos = np.stack(scipy.interpolate.splev(u, tck), axis=1)
    else:  # two keyframes: straight line
        pos = (1 - u)[:, None] * centers[0] + u[:, None] * centers[1]

    out = np.empty((m, 3, 4))
    for a, (ui, p) in enumerate(zip(u, pos)):
        j = min(int(np.searchsorted(knots, ui, side="right")) - 1, n - 2)
        j = max(j, 0)
        t_loc = (ui - knots[j]) / (knots[j + 1] - knots[j])
        q = _slerp(quats[j], quats[j + 1], float(np.clip(t_loc, 0.0, 1.0)))
        out[a, :3, :3] = _quat_to_rotmat(q)
        out[a, :3, 3] = p
    return out


# ---------------------------------------------------------------------------
# PCA pose normalization
# ---------------------------------------------------------------------------

def transform_poses_pca(poses):
    """Recenter/realign ``[n, 3, 4]`` poses onto the principal axes of the
    camera centers and scale into the unit cube.

    Returns ``(poses_recentered [n, 3, 4], transform [4, 4])`` with
    ``poses_recentered = (transform @ [poses; 0 0 0 1])[:, :3]``.
    """
    poses = np.asarray(poses, np.float64)
    centers = poses[:, :3, 3]
    mean = centers.mean(axis=0)
    # principal axes by SVD of the centered center matrix (rows = cameras)
    _, _, vt = np.linalg.svd(centers - mean, full_matrices=False)
    rot = vt  # rows: descending-variance directions
    if np.linalg.det(rot) < 0:
        rot = np.diag([1.0, 1.0, -1.0]) @ rot

    transform = np.eye(4)
    transform[:3, :3] = rot
    transform[:3, 3] = rot @ -mean

    hom = np.concatenate(
        [poses, np.broadcast_to(np.array([0, 0, 0, 1.0]),
                                poses[:, :1, :].shape)], axis=1)
    recentered = (transform @ hom)[:, :3, :]

    # make the average camera-up point along +y (flip y/z if not)
    if recentered[:, 2, 1].mean() < 0:
        flip = np.diag([1.0, -1.0, -1.0])
        recentered = flip @ recentered
        transform = np.diag([1.0, -1.0, -1.0, 1.0]) @ transform

    scale = 1.0 / max(np.abs(recentered[:, :3, 3]).max(), 1e-12)
    recentered[:, :3, 3] *= scale
    transform = np.diag([scale, scale, scale, 1.0]) @ transform
    return recentered, transform


# ---------------------------------------------------------------------------
# spherical orbits
# ---------------------------------------------------------------------------

def pose_spherical(theta, phi, radius):
    """Orbit c2w [4, 4] looking at the origin (OpenGL convention: -z
    forward, +y up), with the D-NeRF-style world axis order (y up swapped
    to z up). theta/phi in degrees."""
    th = np.deg2rad(theta)
    ph = np.deg2rad(phi)
    # camera center on the sphere (before the world axis swap)
    pos = np.array([
        -radius * np.cos(ph) * np.sin(th),
        -radius * np.sin(ph),
        radius * np.cos(ph) * np.cos(th),
    ])
    # look-at basis: backward = away from origin, up = +y
    backward = pos / np.linalg.norm(pos)
    right = np.cross(np.array([0.0, 1.0, 0.0]), backward)
    nr = np.linalg.norm(right)
    right = (right / nr) if nr > 1e-9 else np.array([1.0, 0.0, 0.0])
    up = np.cross(backward, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = backward
    c2w[:3, 3] = pos
    swap = np.array([[-1, 0, 0, 0], [0, 0, 1, 0],
                     [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    return (swap @ c2w).astype(np.float32)


def rodrigues_mat_to_rot(R):
    """SO(3) log map: rotation matrix -> axis-angle vector (reference
    ``utils/pose_utils.py:24-37`` — defined upstream, imported nowhere).

    theta = arccos((tr R - 1) / 2); omega = theta / (2 sin theta) *
    [R32-R23, R13-R31, R21-R12]. Near theta = 0 or pi (sin theta -> 0) the
    reference switches to its small-angle surrogate 0.5 / (1 - theta/6);
    reproduced for parity. ONE documented deviation: trc2 is clipped into
    [-1, 1] before arccos — when float error pushes (tr R - 1)/2 to
    1 + eps on a near-identity rotation the reference returns a NaN
    vector, this port returns the finite ~0 vector (the parity test's
    QR-sampled matrices never hit that degenerate region)."""
    R = np.asarray(R)
    trc2 = (np.trace(R) - 1.0) / 2.0
    s = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    theta = np.arccos(np.clip(trc2, -1.0, 1.0))
    if (1.0 - trc2 * trc2) >= 1e-16:
        factor = theta / (2.0 * np.sin(theta))
    else:
        factor = 0.5 / (1.0 - theta / 6.0)
    return factor * s


def rodrigues_rot_to_mat(r):
    """SO(3) exp map: axis-angle vector -> rotation matrix (reference
    ``utils/pose_utils.py:39-56``): R = cos(t) I + (1-cos t)/t^2 rr^T +
    sin(t)/t [r]_x. Like the reference, NaN at t = 0 exactly (upstream
    divides by t^2 unconditionally)."""
    r = np.asarray(r, np.float64)
    theta = np.linalg.norm(r)
    a = np.cos(theta)
    b = (1.0 - a) / (theta * theta)
    c = np.sin(theta) / theta
    skew = np.array([[0.0, -r[2], r[1]],
                     [r[2], 0.0, -r[0]],
                     [-r[1], r[0], 0.0]])
    return a * np.eye(3) + b * np.outer(r, r) + c * skew


def render_wander_path(R, T, fovy, image_height, num_frames=60,
                       max_disp=5000.0):
    """Sideways 'wander' dolly around one reference view (reference
    ``utils/pose_utils.py:67-99`` — defined upstream, reachable from no
    entry point there; here exposed alongside the other render paths).

    Args:
        R: [3, 3] cam->world rotation (3DGS convention, as stored on
            Camera.R); T: [3] world->cam translation; fovy: radians;
            image_height: pixels.
    Returns [num_frames, 4, 4] c2w-style poses in the reference's
    OpenCV-flipped frame (columns 1/2 negated), matching upstream's
    output convention byte-for-byte.
    """
    from splatfields_torch.utils.camera_math import fov2focal
    focal = fov2focal(fovy, image_height)
    R = np.array(R, np.float64, copy=True)
    R[:, 1] = -R[:, 1]
    R[:, 2] = -R[:, 2]
    pose = np.concatenate(
        [R, -np.asarray(T, np.float64).reshape(3, 1)], axis=-1)
    ref_pose = np.concatenate(
        [pose, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)

    max_trans = max_disp / focal
    out = []
    for i in range(num_frames):
        ang = 2.0 * np.pi * i / num_frames
        trans = np.array([max_trans * np.sin(ang),
                          max_trans * np.cos(ang) / 3.0,
                          max_trans * np.cos(ang) / 3.0])
        i_pose = np.eye(4)
        i_pose[:3, 3] = trans
        out.append((ref_pose @ np.linalg.inv(i_pose)).astype(np.float32))
    return np.stack(out, axis=0)
