"""Pure-functional camera producing view/projection matrices.

Equivalent of the reference fly camera (`Camera.{h,cpp}`): instead
of a mutable class driven by GLFW input, the camera is an immutable pytree
whose matrix getters are traceable jnp functions, so a camera (or a batch of
cameras via vmap) can live inside a jit'd render without host sync.

Conventions match the reference exactly:
  * view = glm::lookAt(position, position + orientation, up)   (Camera.cpp:50-53)
  * proj = glm::perspective(radians(fov), w/h, near, far)      (Camera.cpp:55-58)
    using OpenGL's right-handed, z in [-1, 1] clip convention (GLM default).
  * defaults fov=60 deg, near=0.1, far=256; the app raises far to 5000 at
    startup (Camera.h:71-73, Application.cpp:126).
  * viewport() = normalize(vec2(w, h))                          (Camera.cpp:90-93)
  * focal() = (w, h) / (2 tan(fov/2)); NOTE the reference passes fov in
    *degrees* to tanf (Camera.cpp:95-99) — a latent bug we do not reproduce
    because focal() never feeds the render path (shaders don't consume it).

Matrices are row-major math matrices: `M[i, j]` is row i, column j, and points
transform as `M @ v`. (GLM stores column-major; all reference math has been
de-transposed accordingly.)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp


def _normalize(v: jax.Array, eps: float = 1e-12) -> jax.Array:
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), eps)


def look_at(eye: jax.Array, center: jax.Array, up: jax.Array) -> jax.Array:
    """Right-handed lookAt, identical to glm::lookAt (used at Camera.cpp:52)."""
    f = _normalize(center - eye)
    s = _normalize(jnp.cross(f, up))
    u = jnp.cross(s, f)
    rot = jnp.stack([s, u, -f])  # rows
    trans = -rot @ eye
    view = jnp.eye(4, dtype=eye.dtype)
    view = view.at[:3, :3].set(rot)
    view = view.at[:3, 3].set(trans)
    return view


def perspective(fov_y_rad, aspect, near, far, dtype=jnp.float32) -> jax.Array:
    """Right-handed perspective with z in [-1, 1], identical to glm::perspective
    (used at Camera.cpp:57)."""
    t = jnp.tan(fov_y_rad * 0.5)
    p = jnp.zeros((4, 4), dtype=dtype)
    p = p.at[0, 0].set(1.0 / (aspect * t))
    p = p.at[1, 1].set(1.0 / t)
    p = p.at[2, 2].set(-(far + near) / (far - near))
    p = p.at[2, 3].set(-(2.0 * far * near) / (far - near))
    p = p.at[3, 2].set(-1.0)
    return p


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Immutable camera pytree.

    Array fields are leaves (differentiable / traceable); width and height are
    static metadata so image shapes stay compile-time constants.
    """

    position: jax.Array      # (3,)
    orientation: jax.Array   # (3,) viewing direction (not necessarily unit)
    up: jax.Array            # (3,)
    fov_deg: jax.Array       # () vertical field of view, degrees
    near: jax.Array          # ()
    far: jax.Array           # ()
    width: int = dataclasses.field(metadata=dict(static=True), default=800)
    height: int = dataclasses.field(metadata=dict(static=True), default=800)

    @staticmethod
    def create(position=(0.0, 0.0, 0.0), orientation=(0.0, 0.0, -1.0),
               up=(0.0, 1.0, 0.0), fov_deg=60.0, near=0.1, far=5000.0,
               width=800, height=800, dtype=jnp.float32) -> "Camera":
        """Reference defaults: Camera.h:19-21,71-73 with far=5000
        (Application.cpp:126)."""
        return Camera(
            position=jnp.asarray(position, dtype),
            orientation=jnp.asarray(orientation, dtype),
            up=jnp.asarray(up, dtype),
            fov_deg=jnp.asarray(fov_deg, dtype),
            near=jnp.asarray(near, dtype),
            far=jnp.asarray(far, dtype),
            width=int(width), height=int(height),
        )

    # -- matrix getters (Camera.cpp:44-58) --------------------------------

    @property
    def aspect(self) -> float:
        return float(self.width) / float(self.height)

    def view_matrix(self) -> jax.Array:
        return look_at(self.position, self.position + self.orientation, self.up)

    def proj_matrix(self) -> jax.Array:
        fov = jnp.deg2rad(self.fov_deg)
        return perspective(fov, jnp.asarray(self.aspect, self.position.dtype),
                           self.near, self.far, dtype=self.position.dtype)

    def view_proj_matrix(self) -> jax.Array:
        return self.proj_matrix() @ self.view_matrix()

    # -- auxiliary getters -------------------------------------------------

    def viewport(self) -> jax.Array:
        """normalize(vec2(w, h)) — Camera.cpp:90-93."""
        v = jnp.asarray([self.width, self.height], self.position.dtype)
        return v / jnp.linalg.norm(v)

    def focal(self) -> jax.Array:
        """(w, h) / (2 tan(fov/2)) with fov correctly in radians.

        The reference evaluates tanf on degrees (Camera.cpp:97) but only dead
        CPU paths consume it; we keep the mathematically intended value.
        """
        fov = jnp.deg2rad(self.fov_deg)
        d = 2.0 * jnp.tan(fov * 0.5)
        return jnp.asarray([self.width, self.height], self.position.dtype) / d

    # -- movement helpers (functional analogs of Camera::HandleInput) -----

    def with_pose(self, position=None, orientation=None, up=None) -> "Camera":
        return dataclasses.replace(
            self,
            position=self.position if position is None else jnp.asarray(position, self.position.dtype),
            orientation=self.orientation if orientation is None else jnp.asarray(orientation, self.position.dtype),
            up=self.up if up is None else jnp.asarray(up, self.position.dtype),
        )

    def moved(self, delta: jax.Array) -> "Camera":
        """Translate along world axes (WASD analog, Camera.cpp:130-164)."""
        return dataclasses.replace(self, position=self.position + jnp.asarray(delta, self.position.dtype))

    def orbit(self, angle_rad, axis=(0.0, 1.0, 0.0), center=(0.0, 0.0, 0.0)) -> "Camera":
        """Rotate the camera position about `axis` through `center`, looking at
        `center` — the functional analog of the fixed-view-point mode
        (Camera.cpp:209-229)."""
        from fourdgs.core.transforms import rotate_about_axis
        c = jnp.asarray(center, self.position.dtype)
        p = rotate_about_axis(self.position - c, jnp.asarray(angle_rad), jnp.asarray(axis, self.position.dtype)) + c
        return dataclasses.replace(self, position=p, orientation=_normalize(c - p))


def pixel_centers_ndc(width: int, height: int, dtype=jnp.float32) -> Tuple[jax.Array, jax.Array]:
    """NDC coordinates of pixel centers for an image with row 0 at the TOP.

    GL viewport maps ndc x=-1 -> left, ndc y=+1 -> top of the window; our
    arrays are [H, W] with row 0 top, so ndc_y decreases with the row index.
    Returns (px, py) each of shape (H, W).
    """
    xs = (jnp.arange(width, dtype=dtype) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (jnp.arange(height, dtype=dtype) + 0.5) / height * 2.0
    px = jnp.broadcast_to(xs[None, :], (height, width))
    py = jnp.broadcast_to(ys[:, None], (height, width))
    return px, py
