"""Camera / object transform math.

Port of ``openglraytracer_tpu/ops/transforms.py`` (perspective, view and
camera matrices, batched euler rotations, reflect and refract). Matrices
multiply column vectors, ``M @ v``, exactly as the reference GLSL does.

The camera matrices are computed on the camera's device once per frame. The
inverse view-projection is the reference's float32 ``jnp.linalg.inv``
rounded op for op (``inv4``: the LU with partial pivoting, then the two
triangular solves, as its LAPACK and BLAS run them), in plain tensor ops: a
library inverse on a CUDA device may wait for the host to check its
pivots, which a frame must not do, and rounds otherwise.
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


def _fma(a, b, c):
    """a * b + c rounded once, as fmaf (on a tie of the float64 -> float32
    rounding, about once in 2^29, an ulp apart): the product of float32
    values is exact in float64, so the float64 sum rounds only once."""
    return torch.addcmul(c.double(), a, b).to(c.dtype)


def inv4(m):
    """Inverse of a float32 4x4 as the JAX package's ``jnp.linalg.inv``
    computes it on the CPU, through its BLAS (OpenBLAS): the left-looking
    LU of getf2, one column at a time (the rows above the diagonal by
    forward substitution, each row less its dot product fused from the
    last term back; the rows below it less a fused multiply-add chain from
    the first; partial pivoting on the first largest |entry|, the column
    scaled by the pivot's reciprocal), then the solve of P^T L U X = I
    column-oriented, with fused multiply-adds and each diagonal applied as
    its reciprocal. Bit for bit on every camera of the builders, the OBB
    world's and orbited ones, and on random matrices (the tests); only a
    tie of the float64 -> float32 rounding of a fused multiply-add can
    differ. Sync-free: the pivots stay on the device and
    rows move by index. A fused multiply-add takes one float64 operand
    (``addcmul`` promotes the others inside its kernel): its product is
    exact there, and only the sum rounds."""
    ar = torch.arange(4, device=m.device)
    a, perm = m, ar
    for j in range(4):
        col = a[:, j]
        u = [col[0:1]]                            # U: forward substitution
        for r in range(1, j):
            acc = a[r:r + 1, r - 1] * u[r - 1]
            for k in range(r - 2, -1, -1):
                acc = torch.addcmul(acc, a[r:r + 1, k], u[k].double()).float()
            u.append(col[r:r + 1] - acc)
        low = col[j:]
        if j:                                     # L and the diagonal
            acc = a[j:, 0] * u[0]
            for k in range(1, j):
                acc = torch.addcmul(acc, a[j:, k], u[k].double()).float()
            low = low - acc
        if j == 3:                                # one row left: no pivot
            c = torch.cat(u + [low])
        else:
            p = j + torch.argmax(torch.abs(low))
            sw = torch.where(ar == j, p, torch.where(ar == p, j, ar))
            c = torch.cat(u[:j] + [low])[sw]
            a, perm = a[sw], perm[sw]
            c = torch.cat([c[:j + 1], c[j + 1:] * torch.reciprocal(c[j])])
        a = torch.cat([a[:, :j], c[:, None], a[:, j + 1:]], dim=1)
    a64 = a.double()
    x = (perm[:, None] == ar[None, :]).to(m.dtype)    # P I
    for k in range(3):                                # unit lower
        t = torch.addcmul(x[k + 1:], a64[k + 1:, k:k + 1], x[k:k + 1],
                          value=-1.0).float()
        x = torch.cat([x[:k + 1], t])
    for k in range(3, -1, -1):                        # upper
        rk = x[k:k + 1] * torch.reciprocal(a[k, k])
        if k:
            t = torch.addcmul(x[:k], a64[:k, k:k + 1], rk,
                              value=-1.0).float()
            x = torch.cat([t, rk, x[k + 1:]])
        else:
            x = torch.cat([rk, x[1:]])
    return x


def camera_matrices(cam: Camera):
    """(proj, view, inverse(proj @ view)) — computed once per frame."""
    proj = perspective_matrix(cam.v_fov, cam.aspect, cam.near, cam.far)
    view = view_matrix(cam.position, cam.angles)
    # proj @ view as a sum of outer products in order, each op rounded
    # once: the reference's 4x4 product rounds so (a library matmul need not)
    pv = proj[:, 0:1] * view[0:1, :]
    for k in range(1, 4):
        pv = pv + proj[:, k:k + 1] * view[k:k + 1, :]
    return proj, view, inv4(pv)


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
