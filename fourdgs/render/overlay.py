"""Debug overlays: world-space lines, grid and axis cross.

Analog of the reference Renderer's immediate-mode helpers —
DrawLine (Renderer.cpp:41-77, polyline :79-111), DrawGrid (:113-162),
DrawAxis (:206-215) — drawn by every scene for grid/axis/unit-length/path
visualization (e.g. Scenes.h:303-310). Instead of GL line primitives, each
segment is rasterized analytically: project endpoints, clip at the near
plane, and alpha-blend pixels within half the line width of the 2D segment.

Vectorized over all segments at once; composable over any rendered image.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fourdgs.core.camera import Camera


def _project_points(pts: jax.Array, camera: Camera):
    """World (N, 3) -> (ndc_xy (N, 2), w_clip (N,)). Points behind the
    camera get w <= 0."""
    dtype = pts.dtype
    view = camera.view_matrix().astype(dtype)
    proj = camera.proj_matrix().astype(dtype)
    cam = pts @ view[:3, :3].T + view[:3, 3]
    w = -cam[:, 2]
    x = proj[0, 0] * cam[:, 0]
    y = proj[1, 1] * cam[:, 1]
    return jnp.stack([x, y], -1), w


def draw_lines(image: jax.Array, camera: Camera,
               p0: jax.Array, p1: jax.Array, colors: jax.Array,
               width_px: float = 2.0) -> jax.Array:
    """Blend N world-space segments over `image` (H, W, 4).

    p0/p1 (N, 3) endpoints, colors (N, 4) rgba (alpha scales blending, like
    the reference's translucent grid color {1,1,1,0.15}, Scenes.h:303).
    """
    h, w = image.shape[:2]
    dtype = image.dtype
    eps = 1e-4

    a_ndc, wa = _project_points(p0, camera)
    b_ndc, wb = _project_points(p1, camera)

    # Clip segments crossing the near plane (w = eps): move the behind
    # endpoint to the intersection.
    both_behind = (wa <= eps) & (wb <= eps)
    t_clip = jnp.clip((eps - wa) / jnp.where(jnp.abs(wb - wa) > 1e-12,
                                             wb - wa, 1e-12), 0.0, 1.0)
    clip_pt = a_ndc + (b_ndc - a_ndc) * t_clip[:, None]
    clip_w = wa + (wb - wa) * t_clip
    a_ndc2 = jnp.where((wa <= eps)[:, None], clip_pt, a_ndc)
    wa2 = jnp.where(wa <= eps, clip_w, wa)
    b_ndc2 = jnp.where((wb <= eps)[:, None], clip_pt, b_ndc)
    wb2 = jnp.where(wb <= eps, clip_w, wb)

    # Perspective divide -> pixel coordinates.
    def to_px(ndc, ww):
        sx = ndc[:, 0] / ww
        sy = ndc[:, 1] / ww
        return jnp.stack([(sx + 1.0) * 0.5 * w, (1.0 - sy) * 0.5 * h], -1)

    pa = to_px(a_ndc2, jnp.maximum(wa2, eps))
    pb = to_px(b_ndc2, jnp.maximum(wb2, eps))

    ys = jnp.arange(h, dtype=dtype) + 0.5
    xs = jnp.arange(w, dtype=dtype) + 0.5
    pxg, pyg = jnp.meshgrid(xs, ys)          # (H, W)

    d = pb - pa                                # (N, 2)
    len2 = jnp.maximum(jnp.sum(d * d, -1), 1e-12)

    def seg_layer(img, seg):
        pa_i, d_i, len2_i, col, dead = seg
        relx = pxg - pa_i[0]
        rely = pyg - pa_i[1]
        t = jnp.clip((relx * d_i[0] + rely * d_i[1]) / len2_i, 0.0, 1.0)
        dx = relx - t * d_i[0]
        dy = rely - t * d_i[1]
        dist = jnp.sqrt(dx * dx + dy * dy)
        # Smooth 1px falloff at the edge.
        cov = jnp.clip(0.5 * width_px + 0.5 - dist, 0.0, 1.0)
        alpha = jnp.where(dead, 0.0, cov * col[3])[..., None]
        rgb = img[..., :3] * (1 - alpha) + col[:3] * alpha
        a = img[..., 3:] * (1 - alpha) + alpha
        return jnp.concatenate([rgb, a], -1), None

    segs = (pa.astype(dtype), d.astype(dtype), len2.astype(dtype),
            colors.astype(dtype), both_behind)
    out, _ = jax.lax.scan(seg_layer, image, segs)
    return out


def grid_segments(x_extent: float = 2000.0, z_extent: float = 2000.0,
                  x_count: int = 200, z_count: int = 200,
                  dtype=np.float32):
    """Segment list of DrawGrid(w, h, rows, cols) (Renderer.cpp:113-162):
    x_count+1 lines along z and z_count+1 along x in the y=0 plane, centered
    on the origin. Returns (p0, p1) arrays ((N, 3) each).

    The reference defaults (2000, 2000, 200, 200) make 402 lines; callers
    usually thin this for small images.
    """
    xs = np.linspace(-x_extent / 2, x_extent / 2, x_count + 1, dtype=dtype)
    zs = np.linspace(-z_extent / 2, z_extent / 2, z_count + 1, dtype=dtype)
    p0 = []
    p1 = []
    for x in xs:
        p0.append([x, 0.0, zs[0]])
        p1.append([x, 0.0, zs[-1]])
    for z in zs:
        p0.append([xs[0], 0.0, z])
        p1.append([xs[-1], 0.0, z])
    return np.asarray(p0, dtype), np.asarray(p1, dtype)


def axis_segments(length: float = 500.0, dtype=np.float32):
    """DrawAxis (Renderer.cpp:206-215): +-x red, +-y green, +-z blue."""
    p0 = np.array([[-length, 0, 0], [0, -length, 0], [0, 0, -length]], dtype)
    p1 = np.array([[length, 0, 0], [0, length, 0], [0, 0, length]], dtype)
    colors = np.array([[1, 0, 0, 1], [0, 1, 0, 1], [0, 0, 1, 1]], dtype)
    return p0, p1, colors


def draw_grid(image: jax.Array, camera: Camera, color=(1.0, 1.0, 1.0, 0.15),
              x_count: int = 40, z_count: int = 40,
              extent: float = 2000.0, width_px: float = 1.0) -> jax.Array:
    p0, p1 = grid_segments(extent, extent, x_count, z_count)
    colors = np.broadcast_to(np.asarray(color, np.float32), (p0.shape[0], 4))
    return draw_lines(image, camera, jnp.asarray(p0), jnp.asarray(p1),
                      jnp.asarray(colors), width_px)


def draw_axis(image: jax.Array, camera: Camera, length: float = 500.0,
              width_px: float = 3.0) -> jax.Array:
    p0, p1, colors = axis_segments(length)
    return draw_lines(image, camera, jnp.asarray(p0), jnp.asarray(p1),
                      jnp.asarray(colors), width_px)
