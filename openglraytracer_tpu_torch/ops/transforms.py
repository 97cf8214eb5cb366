"""Camera / object transform math.

Port of ``openglraytracer_tpu/ops/transforms.py`` (perspective, view and
camera matrices, batched euler rotations, reflect and refract). Matrices
multiply column vectors, ``M @ v``, exactly as the reference GLSL does.

The camera matrices are computed on the camera's device once per frame. The
inverse view-projection is formed in closed form, inverse(view) @
inverse(proj), instead of the reference's general 4x4 inverse: the view is a
rigid transform and the projection has a fixed sparsity pattern, and a
general inverse on a CUDA device may wait for the host to check its pivots,
which a frame must not do.
"""

from __future__ import annotations

import math

import torch

from openglraytracer_tpu_torch.models.scene import Camera

DEG_TO_RAD = math.pi / 180.0

# 4x4 products and the (R, 4) x (4, 4) unprojection are float32 products;
# TF32 would keep about three decimal digits of every ray direction.
torch.backends.cuda.matmul.allow_tf32 = False


def perspective_matrix(v_fov, aspect, near, far):
    """Perspective projection (reference calc_projection_matrix)."""
    q = 1.0 / torch.tan(DEG_TO_RAD * 0.5 * v_fov)
    a = q / aspect
    b = (near + far) / (near - far)
    c = (2.0 * near * far) / (near - far)
    z = torch.zeros_like(q)
    one = torch.ones_like(q)
    return torch.stack([
        torch.stack([a, z, z, z]),
        torch.stack([z, q, z, z]),
        torch.stack([z, z, b, c]),
        torch.stack([z, z, -one, z]),
    ])


def _inverse_perspective(v_fov, aspect, near, far):
    """Closed-form inverse of perspective_matrix."""
    q = 1.0 / torch.tan(DEG_TO_RAD * 0.5 * v_fov)
    a = q / aspect
    b = (near + far) / (near - far)
    c = (2.0 * near * far) / (near - far)
    z = torch.zeros_like(q)
    one = torch.ones_like(q)
    return torch.stack([
        torch.stack([1.0 / a, z, z, z]),
        torch.stack([z, 1.0 / q, z, z]),
        torch.stack([z, z, z, -one]),
        torch.stack([z, z, 1.0 / c, b / c]),
    ])


def _rot_cs(deg):
    r = DEG_TO_RAD * deg
    return torch.cos(r), torch.sin(r)


def rotation_matrix_x(deg):
    c, s = _rot_cs(deg)
    z = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack([
        torch.stack([one, z, z, z]),
        torch.stack([z, c, -s, z]),
        torch.stack([z, s, c, z]),
        torch.stack([z, z, z, one]),
    ])


def rotation_matrix_y(deg):
    c, s = _rot_cs(deg)
    z = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack([
        torch.stack([c, z, s, z]),
        torch.stack([z, one, z, z]),
        torch.stack([-s, z, c, z]),
        torch.stack([z, z, z, one]),
    ])


def rotation_matrix_z(deg):
    c, s = _rot_cs(deg)
    z = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, z, z]),
        torch.stack([s, c, z, z]),
        torch.stack([z, z, one, z]),
        torch.stack([z, z, z, one]),
    ])


def euler_rotation_matrix(angles):
    """Rz(yaw) @ Rx(pitch) @ Ry(roll), angles = (pitch, yaw, roll) degrees."""
    return (rotation_matrix_z(angles[..., 1])
            @ rotation_matrix_x(angles[..., 0])
            @ rotation_matrix_y(angles[..., 2]))


def euler_rotation_3x3b(angles):
    """Batched componentwise Rz(yaw) @ Rx(pitch) @ Ry(roll): angles
    (..., 3) degrees -> (..., 3, 3)."""
    r = DEG_TO_RAD * angles
    cp, sp = torch.cos(r[..., 0]), torch.sin(r[..., 0])   # pitch (x)
    cy, sy = torch.cos(r[..., 1]), torch.sin(r[..., 1])   # yaw   (z)
    cr, sr = torch.cos(r[..., 2]), torch.sin(r[..., 2])   # roll  (y)
    row0 = torch.stack([cy * cr - sy * sp * sr, -sy * cp,
                        cy * sr + sy * sp * cr], dim=-1)
    row1 = torch.stack([sy * cr + cy * sp * sr, cy * cp,
                        sy * sr - cy * sp * cr], dim=-1)
    row2 = torch.stack([-cp * sr, sp, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _camera_rotation(angles):
    """3x3 rotation of transform(position, angles) @ Rx(90 deg) — the
    reference's right-handed z-up camera frame."""
    rx90 = rotation_matrix_x(torch.full((), 90.0, dtype=angles.dtype,
                                        device=angles.device))
    return (euler_rotation_matrix(angles) @ rx90)[:3, :3]


def view_matrix(position, angles):
    """inverse(transform(position, angles) @ Rx(90 deg)) (reference
    calc_view_matrix): for T @ R orthonormal, inverse = R^T @ T(-p)."""
    rt = _camera_rotation(angles).T
    top = torch.cat([rt, -(rt @ position)[:, None]], dim=1)
    bottom = torch.eye(4, dtype=rt.dtype, device=rt.device)[3:]
    return torch.cat([top, bottom], dim=0)


def camera_matrices(cam: Camera):
    """(proj, view, inverse(proj @ view)) — computed once per frame."""
    proj = perspective_matrix(cam.v_fov, cam.aspect, cam.near, cam.far)
    view = view_matrix(cam.position, cam.angles)
    rot = _camera_rotation(cam.angles)
    inv_view = torch.cat([
        torch.cat([rot, cam.position[:, None]], dim=1),
        torch.eye(4, dtype=rot.dtype, device=rot.device)[3:]], dim=0)
    inv_proj = _inverse_perspective(cam.v_fov, cam.aspect, cam.near,
                                    cam.far)
    return proj, view, inv_view @ inv_proj


def reflect(d, n):
    """GLSL reflect: d - 2 dot(n, d) n (n assumed unit)."""
    return d - 2.0 * torch.sum(n * d, dim=-1, keepdim=True) * n


def refract(d, n, eta):
    """GLSL refract(I, N, eta): the zero vector on total internal
    reflection. d, n unit vectors; eta the ratio of refraction indices."""
    cos_i = torch.sum(n * d, dim=-1, keepdim=True)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    # double where: sqrt's derivative is infinite at 0, and inf * 0 from the
    # masked branch would make the gradient NaN at grazing incidence
    k_safe = torch.where(k > 0.0, k, 1.0)
    out = eta * d - (eta * cos_i + torch.sqrt(k_safe)) * n
    return torch.where(k > 0.0, out, torch.zeros_like(out))
