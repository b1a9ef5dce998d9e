"""fourdgs — a differentiable 2D/3D/4D Gaussian splat rendering framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
C++/OpenGL renderer `EndMy5uffering/4DGaussianSplatRendering`:

* the full 2D -> 3D -> 4D Gaussian splat progression,
* EWA covariance projection (world-space Sigma -> screen-space conic),
* time-sliced 4D Gaussians with parameterized motion,
* depth ordering (on-device sort; no host round-trips),
* alpha-composited tile rasterization with analytic gradients,
* multi-chip scaling via jax.sharding (splats over a data axis, image tiles
  over a tile axis).

Unlike the reference — a single-GPU interactive viewer whose hot loops are GLSL
shaders plus a CPU sort-key loop (reference `Scenes.h:312-328`) — everything
here lives on device inside one jit, is differentiable end to end, and scales
over a device mesh.

Layer map (mirrors SURVEY.md section 7):
    core/      camera + transform pytrees (reference Camera.{h,cpp})
    splats/    Gaussian parameterizations & covariance builders (reference Splat.h)
    render/    projection, binning, sorting, compositing, pipeline
               (reference Shader/Splats{2,3,4}D GLSL + GPU_RADIX_SORT)
    ops/       Pallas (Triton) kernels for the hot paths + plain references
    parallel/  mesh construction + sharded rendering / training
    io/        .vdata/.sd parsers (reference VDataParser.h), PNG writer
    scenes/    the 11 demo scene generators (reference Scenes.h)
    train/     differentiable-rendering optimization loop (new capability)
"""

__version__ = "0.1.0"

from fourdgs.core.camera import Camera  # noqa: F401

# Lazy re-exports for the most-used entry points (kept lazy so importing
# fourdgs never pulls pallas/pipeline modules eagerly on tiny consumers).
def __getattr__(name):
    if name in ("RenderConfig", "render_splats4d", "render_splats3d",
                "render_splats2d", "render_params4d_packed"):
        from fourdgs.render import pipeline
        return getattr(pipeline, name)
    if name == "auto_render_config":
        from fourdgs.render.autoconfig import auto_render_config
        return auto_render_config
    raise AttributeError(name)
