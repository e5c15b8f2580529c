"""Camera model and pose pipelines.

Matrix convention (load-bearing, shared with the reference so Gaussian sets,
cameras and renders are interchangeable): all 4x4 transforms are stored so
that points transform as ROW vectors, `p_new = [x y z 1] @ M`.  This is the
layout the reference feeds to its CUDA kernels (transformPoint4x3 reads
column-strided elements — auxiliary.h:86-94), i.e. `world_view_transform` is
the transpose of the column-vector world->camera matrix.

Everything in this module but `plucker_rays` is host-side setup math: plain
numpy, float32, run once per batch of cameras.  The render path turns the
resulting `Camera` matrices into tensors on the render device.  A numpy copy
of f3d_gaus_tpu/core/cameras.py (that package's import chain pulls in JAX).
`plucker_rays` (no JAX counterpart) builds the per-pixel rays of posed input
views on their tensors' device, as GS-LRM's tokenizer reads them.
`pose_encoding_to_cameras` (no JAX counterpart) turns VGGT's camera
encoding, which AnySplat predicts, into this module's row-vector cameras,
on tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


class Camera(NamedTuple):
    """A single (or batched: leading dims broadcast) pinhole camera.

    Fields are row-vector-convention matrices as described in the module
    docstring.
    """
    world_view: np.ndarray      # (4, 4) world -> view (row-vector layout)
    full_proj: np.ndarray       # (4, 4) world -> clip  (= world_view @ proj)
    cam_center: np.ndarray      # (3,)   camera origin in world space
    width: int
    height: int
    tan_fovx: float
    tan_fovy: float

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tan_fovy)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection, z_sign=+1, (n+f)/(f-n) depth variant.

    Bit-matches getProjectionMatrix (reference
    src/dataio_gs_test_256_demo.py:237-260); returned UN-transposed
    (column-vector layout); callers transpose for the row-vector chain.
    """
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top = tan_y * znear
    right = tan_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = (znear + zfar) / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def spherical_to_cartesian(yaw, pitch, radius, look_at):
    """Camera origin on a sphere around `look_at` (reference src/camera.py:17-32)."""
    yaw = np.asarray(yaw, np.float32)
    pitch = np.asarray(pitch, np.float32)
    x = -radius * np.sin(yaw) * np.cos(pitch) + look_at[..., 0]
    y = -radius * np.sin(pitch) + look_at[..., 1]
    z = -radius * np.cos(pitch) * np.cos(yaw) + look_at[..., 2]
    return np.stack([x, y, z], -1)


def lookat_cam2world(origins: np.ndarray, look_at: np.ndarray) -> np.ndarray:
    """Look-at matrix chain of the reference (src/camera.py:65-91).

    origins, look_at: (B, 3).  Returns (B, 4, 4).
    """
    fwd = look_at - origins
    fwd = fwd / np.linalg.norm(fwd, axis=-1, keepdims=True)
    up = np.broadcast_to(np.array([0., 1., 0.], np.float32), fwd.shape)
    left = np.cross(up, fwd)
    left = left / np.linalg.norm(left, axis=-1, keepdims=True)
    up2 = np.cross(fwd, left)
    up2 = up2 / np.linalg.norm(up2, axis=-1, keepdims=True)
    B = fwd.shape[0]
    rot = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    rot[:, :3, :3] = np.stack([-left, up2, -fwd], axis=-1)
    trans = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    trans[:, :3, 3] = origins
    return trans @ rot


def orbit_angles(num_frames: int, yaw_diff: float = 0.25, pitch_diff: float = 0.15,
                 base_yaw: float = 0.0, base_pitch: float = 0.0):
    """The "front_circle" orbit of the reference (src/utils.py:64-90):
    yaw = base - yaw_diff*sin(2*pi*s), pitch = base + pitch_diff*cos(2*pi*s),
    s in linspace(0, 1, num_frames)."""
    steps = np.linspace(0.0, 1.0, num_frames, dtype=np.float32)
    yaw = base_yaw - yaw_diff * np.sin(steps * 2 * np.pi)
    pitch = base_pitch + pitch_diff * np.cos(steps * 2 * np.pi)
    return yaw, pitch


class CameraSet(NamedTuple):
    """A batch of B cameras plus auxiliary transforms used by the predictor."""
    world_view: np.ndarray            # (B, 4, 4)
    view_to_world: np.ndarray         # (B, 4, 4)
    full_proj: np.ndarray             # (B, 4, 4)
    cam_centers: np.ndarray           # (B, 3)
    cv2wT_quat: np.ndarray            # (B, 4) quaternion of view->world rot.T

    def camera(self, i: int, width: int, height: int, tan_fovx: float,
               tan_fovy: float) -> Camera:
        return Camera(self.world_view[i], self.full_proj[i], self.cam_centers[i],
                      width, height, tan_fovx, tan_fovy)


def build_camera_set(yaw: np.ndarray, pitch: np.ndarray, radius: float,
                     look_at_z: float, fov_deg: float, znear: float, zfar: float,
                     rebase: Optional[np.ndarray] = None) -> CameraSet:
    """Full reference camera chain (visualize.py:241-279).

    The chain (kept step-for-step so numerics match):
      c2w0 = lookat(spherical(yaw, pitch));  M = inv(c2w0)   # world->cam, col-vec
      Rt = inv(M) ;  world_view = Rt.T ; view_to_world = M.T
      full_proj = world_view @ proj.T ; cam_center = inv(world_view)[3, :3]
    then optional re-basing by `rebase` (= inverse_first_camera, 4x4) exactly
    as update_camera_pose (src/dataio_gs_test_256_demo.py:300-374).
    """
    yaw = np.atleast_1d(np.asarray(yaw, np.float32))
    pitch = np.atleast_1d(np.asarray(pitch, np.float32))
    B = yaw.shape[0]
    look_at = np.zeros((B, 3), np.float32)
    look_at[:, 2] = look_at_z
    origins = spherical_to_cartesian(yaw, pitch, radius, look_at)
    c2w0 = lookat_cam2world(origins, look_at)
    w2c = np.linalg.inv(c2w0)
    Rt = np.linalg.inv(w2c)
    world_view = np.transpose(Rt, (0, 2, 1)).astype(np.float32)
    view_to_world = np.transpose(w2c, (0, 2, 1)).astype(np.float32)
    fov = fov_deg * math.pi / 180.0
    proj_T = projection_matrix(znear, zfar, fov, fov).T
    full_proj = (world_view @ proj_T[None]).astype(np.float32)
    cam_centers = np.linalg.inv(world_view)[:, 3, :3].astype(np.float32)

    if rebase is not None:
        world_view, view_to_world, full_proj, cam_centers = rebase_cameras(
            world_view, view_to_world, full_proj, rebase)

    quats = np.stack([np.asarray(rotmat_to_quat(view_to_world[i, :3, :3].T))
                      for i in range(B)]).astype(np.float32)
    return CameraSet(world_view, view_to_world, full_proj, cam_centers, quats)


def rotmat_to_quat(m) -> np.ndarray:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), (w, x, y, z).

    Branch-free four-case algorithm (reference
    src/dataio_gs_test_256_demo.py:262-297): every candidate is computed and
    the numerically safest one is selected, as in the JAX package.  This
    numpy copy serves the numpy camera code; core/quaternions.py:
    rotmat_to_quat is the differentiable tensor version.
    """
    m = np.asarray(m, np.float32)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = np.float32(1.0) + m00 + m11 + m22

    def safe_sqrt(x):
        return np.sqrt(np.maximum(x, np.float32(1e-12)))

    r0 = safe_sqrt(tr) / np.float32(2.0)
    q0 = np.stack([r0, (m21 - m12) / (4 * r0), (m02 - m20) / (4 * r0),
                   (m10 - m01) / (4 * r0)], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2
    q1 = np.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                   (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2
    q2 = np.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                   (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2
    q3 = np.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                   0.25 * s3], -1)
    use0 = (tr > 0)[..., None]
    use1 = ((m00 > m11) & (m00 > m22))[..., None]
    use2 = (m11 > m22)[..., None]
    return np.where(use0, q0, np.where(use1, q1, np.where(use2, q2, q3))
                    ).astype(np.float32)


def rebase_cameras(world_view, view_to_world, full_proj, inverse_first_camera):
    """Re-express all cameras relative to a canonical first camera
    (reference update_camera_pose, src/dataio_gs_test_256_demo.py:300-374)."""
    inv_first = inverse_first_camera.astype(np.float32)
    new_wv = inv_first[None] @ world_view
    new_v2w = view_to_world @ np.linalg.inv(inv_first)[None]
    new_fp = inv_first[None] @ full_proj
    new_cc = np.linalg.inv(new_wv)[:, 3, :3]
    return (new_wv.astype(np.float32), new_v2w.astype(np.float32),
            new_fp.astype(np.float32), new_cc.astype(np.float32))


def canonical_camera_set(fov_deg: float, radius: float, look_at_z: float,
                         znear: float, zfar: float, update_pose: bool = True):
    """The single canonical input camera of the dataset pipeline
    (src/dataio_gs_test_256_demo.py:78-133).  Returns (CameraSet of size 1,
    inverse_first_camera or None)."""
    base = build_camera_set(np.zeros(1, np.float32), np.zeros(1, np.float32),
                            radius, look_at_z, fov_deg, znear, zfar)
    inv_first = None
    if update_pose:
        inv_first = np.linalg.inv(base.world_view[0]).astype(np.float32)
        wv, v2w, fp, cc = rebase_cameras(base.world_view, base.view_to_world,
                                         base.full_proj, inv_first)
        quat = np.asarray(rotmat_to_quat(v2w[0, :3, :3].T))[None].astype(np.float32)
        base = CameraSet(wv, v2w, fp, cc, quat)
    return base, inv_first


def orbit_camera_set(num_frames: int, fov_deg: float, radius: float,
                     look_at_z: float, znear: float, zfar: float,
                     yaw_diff: float = 0.25, pitch_diff: float = 0.15,
                     rebase: Optional[np.ndarray] = None) -> CameraSet:
    yaw, pitch = orbit_angles(num_frames, yaw_diff, pitch_diff)
    return build_camera_set(yaw, pitch, radius, look_at_z, fov_deg, znear,
                            zfar, rebase=rebase)


def plucker_rays(world_view: torch.Tensor, tan_fovx: float, tan_fovy: float,
                 height: int, width: int, rows: int | None = None):
    """Per-pixel rays of cameras given by row-vector world_view tensors
    (..., 4, 4), in their dtype and on their device.

    Pixel (i, j) looks through its centre, in 3DGS's convention: x at NDC
    (2j + 1) / width - 1 times tan_fovx, y at (2i + 1) / height - 1 times
    tan_fovy (+y down, +z forward, COLMAP's axes).  `rows` (default
    `height`) rows are built: rows past the frame's height continue its
    pixel spacing, the rays of padding below the frame.  Returns the
    camera centres o (..., 3), the unit world directions d (..., rows, W,
    3) and the Plücker coordinates (o × d, d) (..., rows, W, 6)."""
    dt, dev = world_view.dtype, world_view.device
    rot = world_view[..., :3, :3]           # x_view = x_world @ rot + t
    o = -(world_view[..., 3:, :3] @ rot.transpose(-1, -2))[..., 0, :]
    rows = height if rows is None else rows
    ys = ((2 * torch.arange(rows, dtype=dt, device=dev) + 1) / height
          - 1) * tan_fovy
    xs = ((2 * torch.arange(width, dtype=dt, device=dev) + 1) / width
          - 1) * tan_fovx
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    d_cam = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    d = torch.einsum("hwj,...ij->...hwi", d_cam, rot)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o_px = o[..., None, None, :].expand_as(d)
    return o, d, torch.cat([torch.linalg.cross(o_px, d, dim=-1), d], -1)


def quat_xyzw_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) of quaternions (..., 4) in VGGT's
    scalar-last (x, y, z, w) order, which need not be unit: each is
    divided by its squared norm, as VGGT's quat_to_mat does."""
    i, j, k, r = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j)], -1)
    return o.reshape(q.shape[:-1] + (3, 3))


def pose_encoding_to_cameras(enc: torch.Tensor, znear: float,
                             zfar: float) -> dict:
    """Cameras of VGGT's `absT_quaR_FoV` encodings (..., 9): the
    world-to-camera translation T (3), the rotation's quaternion (x, y, z,
    w) and the vertical and horizontal fields of view (radians), in
    OpenCV's camera axes (+x right, +y down, +z forward, as this module's
    view space).  Returns tensors on enc's device: `world_view` and
    `full_proj` (..., 4, 4) in the row-vector layout (full_proj with the
    view's own tangents and the clip planes znear / zfar, as
    projection_matrix builds it), `cam_centers` (..., 3), and `tan_fovx`,
    `tan_fovy` (...)."""
    T, q = enc[..., :3], enc[..., 3:7]
    tan_y = torch.tan(enc[..., 7] / 2)
    tan_x = torch.tan(enc[..., 8] / 2)
    R = quat_xyzw_to_rotmat(q)             # x_cam = R x_world + T
    lead = enc.shape[:-1]
    wv = enc.new_zeros(lead + (4, 4))
    wv[..., :3, :3] = R.transpose(-1, -2)
    wv[..., 3, :3] = T
    wv[..., 3, 3] = 1.0
    proj_t = enc.new_zeros(lead + (4, 4))  # projection_matrix, transposed
    proj_t[..., 0, 0] = 1.0 / tan_x
    proj_t[..., 1, 1] = 1.0 / tan_y
    proj_t[..., 2, 2] = (znear + zfar) / (zfar - znear)
    proj_t[..., 3, 2] = -(zfar * znear) / (zfar - znear)
    proj_t[..., 2, 3] = 1.0
    centers = -(T[..., None, :] @ R)[..., 0, :]
    return {"world_view": wv, "full_proj": wv @ proj_t,
            "cam_centers": centers, "tan_fovx": tan_x, "tan_fovy": tan_y}

