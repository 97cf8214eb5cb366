"""Scene schema: structure-of-arrays tuples of tensors.

Port of ``openglraytracer_tpu/models/scene.py``: the same containers with the
same field names, shapes and dtypes (float32 geometry, int32 material ids),
holding torch tensors instead of JAX arrays.

  * ``Spheres``:  center (N,3), radius (N,), material id (N,)
  * ``Boxes``:    mins/maxs (M,3) in local space, position (M,3),
                  euler angles in degrees (M,3), material id (M,)
  * ``Planes``:   infinite planes  dot(normal, x) = offset
  * ``Materials``: one row per material, referenced by id
  * ``Lights``:   point lights with vec4 ambient/diffuse/specular colors

Every builder and loader puts its tensors on ``device``, the GPU
(``"cuda"``) unless the caller asks for another: without a card that
raises, and a CPU scene (``device="cpu"``) runs the plain PyTorch versions
of the kernels. ``scene_from_numpy`` and ``camera_from_numpy`` take the
nested dict of numpy arrays that a JAX scene converts to (the
``scene_to_dict`` schema), so both packages can compute on identical
inputs.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

# The reference treats any hit with t >= 10000 as a miss.
MISS_T = 10000.0
# Index of refraction of open space.
AIR_IOR = 1.0
# Global time scale applied to scene/camera animation.
TIME_SCALE = 0.4


class Materials(NamedTuple):
    """Phong + raytracing material table."""

    ambient: torch.Tensor        # (K, 4)
    diffuse: torch.Tensor        # (K, 4)
    specular: torch.Tensor       # (K, 4)
    shininess: torch.Tensor      # (K,)
    emissive: torch.Tensor       # (K, 4)
    reflectivity: torch.Tensor   # (K,)
    transparency: torch.Tensor   # (K,)
    refraction_index: torch.Tensor  # (K,)

    @property
    def count(self) -> int:
        return self.shininess.shape[-1]


class Lights(NamedTuple):
    """Point lights."""

    position: torch.Tensor   # (L, 3)
    ambient: torch.Tensor    # (L, 4)
    diffuse: torch.Tensor    # (L, 4)
    specular: torch.Tensor   # (L, 4)

    @property
    def count(self) -> int:
        return self.position.shape[-2]


class Spheres(NamedTuple):
    center: torch.Tensor       # (N, 3)
    radius: torch.Tensor       # (N,)
    material_id: torch.Tensor  # (N,) int32

    @property
    def count(self) -> int:
        return self.radius.shape[-1]


class Boxes(NamedTuple):
    """Oriented boxes: local-space AABB + position + euler angles (degrees)."""

    mins: torch.Tensor         # (M, 3)
    maxs: torch.Tensor         # (M, 3)
    position: torch.Tensor     # (M, 3)
    angles: torch.Tensor       # (M, 3) pitch/yaw/roll degrees
    material_id: torch.Tensor  # (M,) int32

    @property
    def count(self) -> int:
        return self.material_id.shape[-1]


class Planes(NamedTuple):
    """Infinite planes dot(normal, x) = offset."""

    normal: torch.Tensor       # (P, 3) need not be unit length
    offset: torch.Tensor       # (P,)
    material_id: torch.Tensor  # (P,) int32

    @property
    def count(self) -> int:
        return self.offset.shape[-1]


class Scene(NamedTuple):
    spheres: Spheres
    boxes: Boxes
    planes: Planes
    materials: Materials
    lights: Lights

    @property
    def object_count(self) -> int:
        return self.spheres.count + self.boxes.count + self.planes.count


class Camera(NamedTuple):
    position: torch.Tensor  # (3,)
    angles: torch.Tensor    # (3,) pitch/yaw/roll in degrees
    v_fov: torch.Tensor     # scalar, vertical fov degrees
    aspect: torch.Tensor    # scalar, width / height
    near: torch.Tensor      # scalar
    far: torch.Tensor       # scalar


def _t(x, dtype=torch.float32, device="cuda"):
    """Host data -> tensor, rounding float64 to float32 the way jnp.asarray
    does (round to nearest), so builders match the JAX package bit for bit."""
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def make_camera(position, angles=(0.0, 0.0, 0.0), v_fov=90.0,
                aspect=16.0 / 9.0, near=0.1, far=1000.0,
                dtype=torch.float32, device="cuda") -> Camera:
    return Camera(
        position=_t(position, dtype, device),
        angles=_t(angles, dtype, device),
        v_fov=_t(v_fov, dtype, device),
        aspect=_t(aspect, dtype, device),
        near=_t(near, dtype, device),
        far=_t(far, dtype, device),
    )


def _stack_vec4(rows, dtype, device):
    out = np.zeros((len(rows), 4), np.float64)
    for i, r in enumerate(rows):
        r = np.atleast_1d(np.asarray(r, np.float64))
        if r.shape == (1,):          # scalar: vec4(x)
            r = np.full(4, r[0])
        elif r.shape == (3,):        # rgb: alpha 1
            r = np.concatenate([r, [1.0]])
        out[i] = r
    return _t(out, dtype, device)


def make_materials(rows, dtype=torch.float32, device="cuda") -> Materials:
    """rows: list of dicts with keys ambient, diffuse, specular, shininess,
    emissive, reflectivity, transparency, refraction_index. Scalar color
    values broadcast to all 4 channels (GLSL vec4(x) semantics)."""
    def vec4(key, default):
        return _stack_vec4([r.get(key, default) for r in rows], dtype, device)

    def scalar(key, default):
        return _t([float(r.get(key, default)) for r in rows], dtype, device)

    return Materials(
        ambient=vec4("ambient", 1.0),
        diffuse=vec4("diffuse", 1.0),
        specular=vec4("specular", 1.0),
        shininess=scalar("shininess", 1.0),
        emissive=vec4("emissive", 0.0),
        reflectivity=scalar("reflectivity", 0.0),
        transparency=scalar("transparency", 0.0),
        refraction_index=scalar("refraction_index", 1.0),
    )


def make_lights(rows, dtype=torch.float32, device="cuda") -> Lights:
    return Lights(
        position=_t([r["position"] for r in rows], dtype, device),
        ambient=_stack_vec4([r.get("ambient", 0.0) for r in rows], dtype,
                            device),
        diffuse=_stack_vec4([r.get("diffuse", 0.0) for r in rows], dtype,
                            device),
        specular=_stack_vec4([r.get("specular", 0.0) for r in rows], dtype,
                             device),
    )


def empty_spheres(dtype=torch.float32, device="cuda") -> Spheres:
    return Spheres(torch.zeros((0, 3), dtype=dtype, device=device),
                   torch.zeros((0,), dtype=dtype, device=device),
                   torch.zeros((0,), dtype=torch.int32, device=device))


def empty_boxes(dtype=torch.float32, device="cuda") -> Boxes:
    z3 = torch.zeros((0, 3), dtype=dtype, device=device)
    return Boxes(z3, z3, z3, z3,
                 torch.zeros((0,), dtype=torch.int32, device=device))


def empty_planes(dtype=torch.float32, device="cuda") -> Planes:
    return Planes(torch.zeros((0, 3), dtype=dtype, device=device),
                  torch.zeros((0,), dtype=dtype, device=device),
                  torch.zeros((0,), dtype=torch.int32, device=device))


def make_scene(spheres=None, boxes=None, planes=None, materials=None,
               lights=None) -> Scene:
    """Assemble a Scene; missing primitive sets are empty on the device of
    the materials table."""
    if materials is None or lights is None:
        raise ValueError("materials and lights are required")
    device = materials.shininess.device
    return Scene(
        spheres=spheres if spheres is not None else empty_spheres(
            device=device),
        boxes=boxes if boxes is not None else empty_boxes(device=device),
        planes=planes if planes is not None else empty_planes(device=device),
        materials=materials,
        lights=lights,
    )


# ---------------------------------------------------------------------------
# The reference's material and light constants, kept as plain data so that
# port-fidelity scenes (models/animated.py) can be assembled from them
# ---------------------------------------------------------------------------

REF_MATERIALS = {
    # name -> dict; order of fields mirrors the GLSL Material initializers
    "material1": dict(ambient=1.0, diffuse=(0.5, 0.0, 0.0, 1.0), specular=1.0,
                      shininess=4.0, emissive=0.0, reflectivity=1.0,
                      transparency=0.0, refraction_index=1.5),
    "material2": dict(ambient=1.0, diffuse=(0.3, 0.6, 0.3, 1.0), specular=1.0,
                      shininess=4.0, emissive=0.0, reflectivity=1.0,
                      transparency=0.0, refraction_index=1.5),
    "red_glass": dict(ambient=1.0, diffuse=(1.0, 0.0, 0.0, 1.0), specular=1.0,
                      shininess=10.0, emissive=0.0, reflectivity=0.8,
                      transparency=0.4, refraction_index=1.5),
    "green_glass": dict(ambient=1.0, diffuse=(0.0, 1.0, 0.0, 1.0),
                        specular=1.0, shininess=10.0, emissive=0.0,
                        reflectivity=0.4, transparency=0.6,
                        refraction_index=1.5),
    "blue_glass": dict(ambient=1.0, diffuse=(0.0, 0.0, 1.0, 1.0), specular=1.0,
                       shininess=10.0, emissive=0.0, reflectivity=0.4,
                       transparency=0.6, refraction_index=1.5),
    "mirror": dict(ambient=1.0, diffuse=(0.6, 0.6, 0.6, 1.0), specular=1.0,
                   shininess=4.0, emissive=0.0, reflectivity=1.0,
                   transparency=0.0, refraction_index=1.0),
    "wall": dict(ambient=0.5, diffuse=0.4, specular=0.3, shininess=3.0,
                 emissive=0.0, reflectivity=0.3, transparency=0.0,
                 refraction_index=1.0),
}

REF_LIGHTS = [
    # World ambient light (its position still spawns shadow rays in the
    # reference)
    dict(position=(0.1, 0.1, 0.1), ambient=0.3, diffuse=0.0, specular=0.0),
    # Point Light #1 (white)
    dict(position=(7.0, 7.0, 2.0), ambient=0.05, diffuse=1.0, specular=1.0),
    # Point Light #2 (red)
    dict(position=(3.0, -3.0, 4.0), ambient=0.05,
         diffuse=(1.0, 0.0, 0.0, 1.0), specular=(1.0, 0.0, 0.0, 1.0)),
]


# ---------------------------------------------------------------------------
# Transfer from the JAX package and JSON scene IO
# ---------------------------------------------------------------------------

_SUBTREES = (("spheres", Spheres), ("boxes", Boxes), ("planes", Planes),
             ("materials", Materials), ("lights", Lights))


def scene_from_numpy(tree: dict, device="cuda") -> Scene:
    """Scene from a nested dict of numpy arrays ``{"spheres": {"center":
    ..., ...}, ...}`` (the ``scene_to_dict`` schema), keeping each array's
    dtype and values exactly."""
    return Scene(*(cls(**{f: torch.from_numpy(np.array(tree[key][f]))
                          .to(device) for f in cls._fields})
                   for key, cls in _SUBTREES))


def camera_from_numpy(tree: dict, device="cuda") -> Camera:
    """Camera from a dict of numpy arrays keyed by Camera's fields."""
    return Camera(**{f: torch.from_numpy(np.array(tree[f])).to(device)
                     for f in Camera._fields})


def scene_to_dict(scene: Scene) -> dict:
    def arr(x):
        return x.detach().cpu().numpy().tolist()
    return {key: {k: arr(v) for k, v in getattr(scene, key)._asdict().items()}
            for key, _ in _SUBTREES}


def scene_from_dict(d: dict, dtype=torch.float32, device="cuda") -> Scene:
    # trailing dims of each 2-D column (everything else is 1-D)
    vec_cols = {"center": 3, "mins": 3, "maxs": 3, "position": 3, "angles": 3,
                "normal": 3, "ambient": 4, "diffuse": 4, "specular": 4,
                "emissive": 4}

    def load(cls, key, int_keys=("material_id",)):
        sub = d.get(key)
        if sub is None:
            sub = {f: (np.zeros((0, vec_cols[f])) if f in vec_cols
                       else np.zeros((0,))) for f in cls._fields}
        if not isinstance(sub, dict):
            raise ValueError(
                f"scene JSON: '{key}' must be a dict of column arrays "
                f"(fields: {list(cls._fields)}), got {type(sub).__name__}; "
                f"see scene_to_dict / save_scene for the schema")
        missing = set(cls._fields) - set(sub)
        if missing:
            raise ValueError(
                f"scene JSON: '{key}' is missing columns {sorted(missing)}")
        def column(k, v):
            x = _t(v, torch.int32 if k in int_keys else dtype, device)
            # an empty 2-D column is written to JSON as [], shape (0,)
            return x.reshape(0, vec_cols[k]) if (
                x.numel() == 0 and k in vec_cols) else x
        return cls(**{k: column(k, v) for k, v in sub.items()})

    return Scene(
        spheres=load(Spheres, "spheres"),
        boxes=load(Boxes, "boxes"),
        planes=load(Planes, "planes"),
        materials=load(Materials, "materials", int_keys=()),
        lights=load(Lights, "lights", int_keys=()),
    )


def camera_to_dict(camera: Camera) -> dict:
    return {k: v.detach().cpu().numpy().tolist()
            for k, v in camera._asdict().items()}


def camera_from_dict(d: dict, dtype=torch.float32, device="cuda") -> Camera:
    missing = set(Camera._fields) - set(d)
    if missing:
        raise ValueError(f"scene JSON: 'camera' is missing {sorted(missing)}")
    return Camera(**{k: _t(d[k], dtype, device) for k in Camera._fields})


def save_scene(scene: Scene, path: str, camera: Camera | None = None) -> None:
    """Save scene (+ optionally its camera) as JSON."""
    d = scene_to_dict(scene)
    if camera is not None:
        d["camera"] = camera_to_dict(camera)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


def load_scene_camera(path: str, dtype=torch.float32, device="cuda"):
    """(Scene, Camera | None) from a scene JSON; None when the file has no
    'camera' entry."""
    with open(path) as f:
        d = json.load(f)
    cam = (camera_from_dict(d["camera"], dtype, device) if "camera" in d
           else None)
    return scene_from_dict(d, dtype, device), cam
