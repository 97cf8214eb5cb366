"""NumPy CPU reference renderer — the correctness oracle.

A copy of ``openglraytracer_tpu/utils/oracle.py`` (pure NumPy) that takes
the port's Scene and Camera: only ``_np`` differs, and the camera goes
through it too. It gives the same float64 numbers as the reference's.

The reference repo ships zero tests (SURVEY.md §4); its only oracle was your
eyeballs. This module is an independent NumPy transliteration of the GLSL
pipeline's *semantics* (raytrace_compute.glsl: camera :332-393, sphere :583-640,
box :647-724, closest :738-782, phong :789-840, recursion :844-1105), written
deliberately in the reference's scalar style (loop over objects and lights,
true Python recursion over depth) so that the vectorized/chunked/scanned JAX
renderer is validated against structurally *different* code computing the same
function.

Vectorized only over pixels; everything else mirrors the GLSL control flow,
including its quirks (unnormalized shadow segment with t < 1, rgb*alpha phong
output, inside-hit normal flips, first-object-wins ties, eps offsets 0.01 /
0.001, TIR refract -> zero vector -> black child).

Works in float64 (default) or float32. Not fast; use small resolutions.
"""

from __future__ import annotations

import numpy as np

MISS_T = 10000.0
AIR_IOR = 1.0
DEG2RAD = np.pi / 180.0


# ---------------------------------------------------------------------------
# Scene access: consumes the same Scene pytree (converted to numpy)
# ---------------------------------------------------------------------------

def _np(tree):
    """The port's Scene or Camera (NamedTuples of tensors, on any device)
    with every tensor as a numpy array."""
    if isinstance(tree, tuple):
        return type(tree)(*(_np(x) for x in tree))
    return tree.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Transforms (GLSL :411-545)
# ---------------------------------------------------------------------------

def perspective(v_fov, aspect, near, far, dtype):
    q = 1.0 / np.tan(DEG2RAD * 0.5 * v_fov)
    m = np.zeros((4, 4), dtype)
    m[0, 0] = q / aspect
    m[1, 1] = q
    m[2, 2] = (near + far) / (near - far)
    m[2, 3] = (2.0 * near * far) / (near - far)
    m[3, 2] = -1.0
    return m


def rot_x(deg, dtype):
    c, s = np.cos(DEG2RAD * deg), np.sin(DEG2RAD * deg)
    m = np.eye(4, dtype=dtype)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rot_y(deg, dtype):
    c, s = np.cos(DEG2RAD * deg), np.sin(DEG2RAD * deg)
    m = np.eye(4, dtype=dtype)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rot_z(deg, dtype):
    c, s = np.cos(DEG2RAD * deg), np.sin(DEG2RAD * deg)
    m = np.eye(4, dtype=dtype)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def euler_rot(angles, dtype):
    """Rz(yaw) @ Rx(pitch) @ Ry(roll) (GLSL rotation_matrix(vec3), :492-503)."""
    return rot_z(angles[1], dtype) @ rot_x(angles[0], dtype) @ rot_y(angles[2], dtype)


def translation(t, dtype):
    m = np.eye(4, dtype=dtype)
    m[:3, 3] = t
    return m


def transform_mat(position, angles, dtype):
    return translation(position, dtype) @ euler_rot(angles, dtype)


def view_mat(position, angles, dtype):
    return np.linalg.inv(
        transform_mat(position, angles, dtype) @ rot_x(90.0, dtype)
    ).astype(dtype)


# ---------------------------------------------------------------------------
# Ray generation (GLSL :372-393)
# ---------------------------------------------------------------------------

def generate_rays(camera, height, width, dtype=np.float64):
    pos = np.asarray(camera.position, dtype)
    ang = np.asarray(camera.angles, dtype)
    proj = perspective(float(camera.v_fov), float(camera.aspect),
                       float(camera.near), float(camera.far), dtype)
    view = view_mat(pos, ang, dtype)
    inv_vp = np.linalg.inv(proj @ view)

    px = np.arange(width)
    py = np.arange(height)
    x = (px - width // 2) / (width // 2)
    y = (py - height // 2) / (height // 2)
    xg, yg = np.meshgrid(x.astype(dtype), y.astype(dtype))  # (H, W)

    def unproject(z):
        clip = np.stack([xg, yg, np.full_like(xg, z), np.ones_like(xg)], -1)
        world = clip @ inv_vp.T
        return world[..., :3] / world[..., 3:4]

    start = unproject(0.5)
    end = unproject(1.0)
    d = end - start
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(pos, d.shape).copy()
    return o.reshape(-1, 3), d.reshape(-1, 3)


# ---------------------------------------------------------------------------
# Intersections. Each returns dict(t, p, n, inside); t = -1 rows on miss,
# vectorized over rays, one object at a time (the GLSL's structure).
# ---------------------------------------------------------------------------

def intersect_sphere(o, d, center, radius):
    oc = o - center
    qa = np.sum(d * d, -1)
    qb = 2.0 * np.sum(d * oc, -1)
    qc = np.sum(oc * oc, -1) - radius * radius
    qd = qb * qb - 4.0 * qa * qc

    with np.errstate(invalid="ignore", divide="ignore"):
        sq = np.sqrt(np.maximum(qd, 0.0))
        t1 = (-qb + sq) / (2.0 * qa)
        t2 = (-qb - sq) / (2.0 * qa)
    t_near = np.minimum(t1, t2)
    t_far = np.maximum(t1, t2)

    inside = t_near < 0.0
    t = np.where(inside, t_far, t_near)
    miss = (qd < 0.0) | (t_far < 0.0) | ~np.isfinite(t)
    t = np.where(miss, -1.0, t)
    p = o + t[:, None] * d
    n = p - center
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        n = np.where(norm > 0, n / norm, n)
    n = np.where(inside[:, None], -n, n)
    return dict(t=t, p=p, n=n, inside=inside & ~miss)


def intersect_box(o, d, mins, maxs, position, angles):
    dtype = o.dtype
    l2w = transform_mat(position, angles, dtype)
    w2l = np.linalg.inv(l2w)
    ro = (np.concatenate([o, np.ones((len(o), 1), dtype)], -1) @ w2l.T)[:, :3]
    rd = (np.concatenate([d, np.zeros((len(d), 1), dtype)], -1) @ w2l.T)[:, :3]

    with np.errstate(invalid="ignore", divide="ignore"):
        ta = (mins - ro) / rd
        tb = (maxs - ro) / rd
    t1 = np.minimum(ta, tb)
    t2 = np.maximum(ta, tb)
    t_near = np.max(t1, -1)
    t_far = np.min(t2, -1)

    miss = (t_near >= t_far) | (t_far <= 0.0) | ~np.isfinite(t_near) | ~np.isfinite(t_far)
    inside = (t_near < 0.0) & ~miss
    t = np.where(inside, t_far, t_near)
    boundary = np.where(inside[:, None], t2, t1)

    face = np.zeros(len(o), np.int64)
    face = np.where(t == boundary[:, 1], 1, face)
    face = np.where((t != boundary[:, 1]) & (t == boundary[:, 2]), 2, face)

    n_local = np.zeros_like(o)
    n_local[np.arange(len(o)), face] = 1.0
    flip = np.take_along_axis(rd, face[:, None], axis=1)[:, 0] > 0.0
    n_local = np.where(flip[:, None], -n_local, n_local)

    normal_mat = np.linalg.inv(l2w[:3, :3]).T
    n = n_local @ normal_mat.T

    # a missed ray's t can be +/-inf (axis-parallel slab divisions); its hit
    # point is masked downstream, so compute p from a zeroed t to keep the
    # oracle NaN/RuntimeWarning-clean (VERDICT r3 next #9)
    t_safe = np.where(miss, 0.0, t)
    p_local = ro + t_safe[:, None] * rd
    p = (np.concatenate([p_local, np.ones((len(o), 1), dtype)], -1) @ l2w.T)[:, :3]
    t = np.where(miss, -1.0, t)
    return dict(t=t, p=p, n=n, inside=inside)


def intersect_plane(o, d, normal, offset):
    nd = d @ normal
    no = o @ normal
    with np.errstate(invalid="ignore", divide="ignore"):
        t = (offset - no) / nd
    miss = (np.abs(nd) <= 1.0e-9) | (t <= 0.0) | ~np.isfinite(t)
    t = np.where(miss, -1.0, t)
    p = o + t[:, None] * d
    n_unit = normal / np.linalg.norm(normal)
    n = np.where(nd[:, None] > 0.0, -n_unit, n_unit)
    return dict(t=t, p=p, n=n * np.ones_like(o), inside=np.zeros(len(o), bool))


def _iter_objects(s):
    """Yield (obj_id, material_id, intersect_fn) in the global object order:
    spheres, then boxes, then planes."""
    idx = 0
    for i in range(len(s.spheres.radius)):
        yield idx, int(s.spheres.material_id[i]), (
            lambda o, d, i=i: intersect_sphere(
                o, d, s.spheres.center[i], s.spheres.radius[i]))
        idx += 1
    for i in range(len(s.boxes.material_id)):
        yield idx, int(s.boxes.material_id[i]), (
            lambda o, d, i=i: intersect_box(
                o, d, s.boxes.mins[i], s.boxes.maxs[i],
                s.boxes.position[i], s.boxes.angles[i]))
        idx += 1
    for i in range(len(s.planes.material_id)):
        yield idx, int(s.planes.material_id[i]), (
            lambda o, d, i=i: intersect_plane(
                o, d, s.planes.normal[i], s.planes.offset[i]))
        idx += 1


def closest_hit(s, o, d):
    """GLSL get_closest_collision (:738-782): linear scan, t<=0 rejected,
    strict < keeps the first object on ties, initial bound 10000."""
    r = len(o)
    best = dict(
        t=np.full(r, MISS_T, o.dtype), p=np.zeros_like(o), n=np.zeros_like(o),
        inside=np.zeros(r, bool), obj_id=np.full(r, -1, np.int64),
        material_id=np.zeros(r, np.int64),
    )
    for obj_id, mat_id, fn in _iter_objects(s):
        c = fn(o, d)
        ok = (c["t"] > 0.0) & (c["t"] < best["t"])
        for k in ("t", "p", "n"):
            best[k] = np.where((ok[:, None] if best[k].ndim == 2 else ok),
                               c[k], best[k])
        best["inside"] = np.where(ok, c["inside"], best["inside"])
        best["obj_id"] = np.where(ok, obj_id, best["obj_id"])
        best["material_id"] = np.where(ok, mat_id, best["material_id"])
    best["hit"] = best["obj_id"] >= 0
    return best


# ---------------------------------------------------------------------------
# Shading (GLSL ads_phong_lighting, :789-840)
# ---------------------------------------------------------------------------

def _normalize(v):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(n > 0, v / n, v)


def _reflect(d, n):
    return d - 2.0 * np.sum(n * d, -1, keepdims=True) * n


def _refract(d, n, eta):
    cos_i = np.sum(n * d, -1, keepdims=True)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    out = eta * d - (eta * cos_i + np.sqrt(np.maximum(k, 0.0))) * n
    return np.where(k < 0.0, 0.0, out)


def phong_shade(s, d, hit):
    mat_id = hit["material_id"]
    m = s.materials
    ambient = np.zeros((len(d), 4), d.dtype)
    diffuse = np.zeros_like(ambient)
    specular = np.zeros_like(ambient)

    view_dir = _normalize(-d)
    for j in range(len(s.lights.position)):
        lpos = s.lights.position[j]
        ambient += s.lights.ambient[j] * m.ambient[mat_id]

        to_light = lpos - hit["p"]
        light_dir = _normalize(to_light)
        sh = closest_hit(s, hit["p"] + hit["n"] * 0.01, to_light)
        lit = ~(sh["hit"] & (sh["t"] < 1.0))

        light_ref = _normalize(_reflect(-light_dir, hit["n"]))
        cos_theta = np.sum(light_dir * hit["n"], -1, keepdims=True)
        cos_phi = np.sum(view_dir * light_ref, -1, keepdims=True)

        shin = m.shininess[mat_id][:, None]
        diffuse += lit[:, None] * s.lights.diffuse[j] * m.diffuse[mat_id] \
            * np.maximum(cos_theta, 0.0)
        with np.errstate(invalid="ignore"):
            spec_pow = np.where(cos_phi > 0.0,
                                np.maximum(cos_phi, 0.0) ** shin, 0.0)
        specular += lit[:, None] * s.lights.specular[j] * m.specular[mat_id] \
            * spec_pow

    phong = ambient + diffuse + specular + m.emissive[mat_id]
    return phong[:, :3] * phong[:, 3:4]


# ---------------------------------------------------------------------------
# Recursion (GLSL :844-1105) as true Python recursion over the bounce tree
# ---------------------------------------------------------------------------

def trace(s, o, d, depth):
    hit = closest_hit(s, o, d)
    color = phong_shade(s, d, hit)
    m = s.materials
    mat_id = hit["material_id"]

    if depth > 0:
        refl = m.reflectivity[mat_id][:, None]
        refl_color = trace(s, hit["p"] + hit["n"] * 1.0e-3,
                           _reflect(d, hit["n"]), depth - 1)
        do_refl = hit["hit"][:, None] & (refl > 0.0)
        color = np.where(do_refl, color * (1 - refl) + refl_color * refl, color)

        transp = m.transparency[mat_id][:, None]
        ior = m.refraction_index[mat_id][:, None]
        ratio = np.where(hit["inside"][:, None], ior / AIR_IOR, AIR_IOR / ior)
        refr_dir = _refract(d, hit["n"], ratio)
        refr_color = trace(s, hit["p"] - hit["n"] * 1.0e-3, refr_dir, depth - 1)
        do_refr = hit["hit"][:, None] & (transp > 0.0)
        color = np.where(do_refr, color * (1 - transp) + refr_color * transp,
                         color)

    return np.where(hit["hit"][:, None], color, 0.0)


def render(scene, camera, height, width, depth=0, dtype=np.float64):
    """Oracle render -> (H, W, 3) numpy image."""
    s = _np(scene)
    o, d = generate_rays(_np(camera), height, width, dtype)
    colors = trace(s, o.astype(dtype), d.astype(dtype), depth)
    return colors.reshape(height, width, 3)
