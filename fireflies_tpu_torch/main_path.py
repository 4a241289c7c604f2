"""The main path: the pattern-optimization inner loop on the vocalfold scene.

The workload of the reference's benchmark (`bench.py::measure`): build
`vocalfold(resolution=24, n_anim_frames=4)` (1440 faces), randomize one
variant per seed, attach the analytic beam-splat projector of a 12x12
laser pattern, assemble, path-trace every variant (512x512, spp 1,
2 bounces, static geometry), and differentiate the mean image with respect
to the (144, 3) beam directions.  `bench.py` also records the
reference-realistic shape: `resolution=75` (11538 faces) at spp 4 with
`coherent_bounce` and `shared_primary`, which runs on the streamed kernels.
Each shape also runs with tile culling off (`tile_cull=False`, the
reference's FF_NO_TILE_CULL=1), on the kernels without cluster lists.

    bridge, randomize, beams = build(device, resolution)
    img = render_batch(bridge, randomize, beams, seeds, cfg)      # (B, H, W, 3)
    loss, grad = pattern_step(bridge, randomize, beams, seeds, cfg)

`analytic=False` takes the reference's texture route (`bench.py`'s
`analytic=0` rows): the beams are rasterized once a step into a 256x256
texture that every variant's projector looks up.

Geometry gradients take the face-table attribute route
(`static_geometry=False`): `pose_step` is the loss and gradient with
respect to a (3,) translation of every mesh, as `bench.py`'s `pose_soft`
row measures it (path-traced L2 plus a soft-silhouette mask L2 against
targets rendered once):

    targets = pose_targets(bridge, randomize, beams, seeds, cfg)
    loss, grad = pose_step(bridge, randomize, beams, delta, seeds, targets, cfg)

With `RenderConfig(reparam=True)` the same two calls are `bench.py`'s
`pose_reparam` row: the path-traced L2 alone (`optim.image_l2`), its
silhouette and shadow-edge gradients from the warped-area pass
(render/reparam.py), no soft silhouette.

Around the render run the two loops users run: the pattern optimizer
(`variant_loss` for `optim.optimize_pattern_through_render`, each step's
variants randomized at that step's index) and the dataset farm
(`datagen_batch` for `datagen.generate_dataset`, consecutive frame steps):

    loss_fn = variant_loss(bridge, randomize, cfg, optim.dot_coverage_objective(1))
    res = optim.optimize_pattern_through_render(loss_fn, beams, seed, steps, batch)
    n = datagen.generate_dataset(datagen_batch(bridge, randomize, beams, cfg), ...)

Two shapes take the rest of the renderer's shading (`BUILDERS`, through
`build_shape` like SHAPES'): `materials`, the reference's farm scene
(examples/vocalfold_scene.py's randomization: fold scale and rotation,
clearcoat, roughness and sheen of the mucosa, a grey spot intensity) with
material maps, and `emitters`, `cornell_like` with a glass sphere, a thin
translucent box, anisotropic and flat walls, an area light, a point light
with an aperture and an envmap.  Two more take the vocalfold scene from a
file, as users load it (`BUILDERS` too): `xml`, the Mitsuba export
tools/parity_scenes/vocalfold.xml through
`utils.mitsuba_xml.scene_from_mitsuba_xml`, and `yaml`, a scene
description written by `scene_io.save_scene_description` and read back by
`scene_io.load_scene`, its fold animated from OBJ frames and its mucosa
textured by a `NoiseTextureLerpSampler`.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import torch

import numpy as np

from fireflies_tpu_torch import sampling, scene_io
from fireflies_tpu_torch.assets import procedural, scenes
from fireflies_tpu_torch.entity import Mesh, Transformable
from fireflies_tpu_torch.material import Material
from fireflies_tpu_torch.optim import hybrid_pose_loss, image_l2, make_variant_loss
from fireflies_tpu_torch.postprocessing import gaussian_blur2d
from fireflies_tpu_torch.projection import laser
from fireflies_tpu_torch.render import (
    RenderConfig,
    SceneBridge,
    render_rgb,
    render_segmentation,
)
from fireflies_tpu_torch.render.soft import render_soft_silhouette
from fireflies_tpu_torch.render.types import Camera, Geometry, Lights, Materials, RenderScene
from fireflies_tpu_torch.utils import io as ffio
from fireflies_tpu_torch.utils import math as ffmath
from fireflies_tpu_torch.utils.mitsuba_xml import scene_from_mitsuba_xml

Tensor = torch.Tensor

PROJECTOR_FOV = 30.0
BEAM_SIGMA = 10.0
BEAM_TEXTURE = (256, 256)

# The shapes chip_smoke.py drives, by name: (vocalfold resolution,
# bench_config settings beside size, and `smooth` for build).  All have 2
# bounces and a batch of 16 there.  Faces (fold + 288 tube): main 1440, the
# benchmark default (B1 and B3); mid 5288, the mid-sized route (B1 and B5);
# reference 11538, the reference-realistic shape (B2 and B4).  The
# `_unculled` shapes turn tile culling off: main_unculled on B6 and B3,
# reference_unculled on B7s and B7g with the attribute gather.  The
# `geometry` shapes take the face-table attribute route: geometry is main
# with smooth normals (B1 and B3), reference_geometry bench.py's
# static_geom=0 row (B2 and B4 without kernel-emitted attributes).
_REFERENCE = dict(spp=4, coherent_bounce=True, shared_primary=True)
SHAPES = {
    "main": (24, {}),
    "mid": (50, {}),
    "reference": (75, _REFERENCE),
    "main_unculled": (24, dict(tile_cull=False)),
    "reference_unculled": (75, dict(_REFERENCE, tile_cull=False)),
    "geometry": (24, dict(static_geometry=False, smooth=True)),
    "reference_geometry": (75, dict(spp=4, coherent_bounce=True, static_geometry=False)),
}


def bench_config(size: int = 512, spp: int = 1, bounces: int = 2, coherent_bounce: bool = False,
                 shared_primary: bool = False, tile_cull: bool = True,
                 static_geometry: bool = True) -> RenderConfig:
    return RenderConfig(width=size, height=size, spp=spp, max_bounces=bounces,
                        static_geometry=static_geometry, coherent_bounce=coherent_bounce,
                        shared_primary=shared_primary, tile_cull=tile_cull)


def build(device="cuda", resolution: int = SHAPES["main"][0], smooth: bool = False):
    """(bridge, randomize, beams): the vocalfold scene at `resolution`
    (`smooth`: shaded with vertex normals), its randomize function on
    `device` (the card unless the caller asks for the CPU), and the (144, 3)
    uniform beam pattern."""
    scene, kw = scenes.vocalfold(resolution=resolution, n_anim_frames=4, smooth=smooth)
    bridge = SceneBridge(scene, **kw)
    randomize = scene.compile(device=device)
    beams = laser.generate_uniform_rays(0.0275, 12, 12, device=device)
    return bridge, randomize, beams


def build_shape(name: str, device="cuda", size: int = 512):
    """(bridge, randomize, beams, cfg) of the shape `name` of SHAPES or
    BUILDERS at a size x size film."""
    if name in BUILDERS:
        return BUILDERS[name](device, size)
    resolution, settings = SHAPES[name]
    settings = dict(settings)
    smooth = settings.pop("smooth", False)
    return (*build(device, resolution=resolution, smooth=smooth),
            bench_config(size=size, **settings))


def generators(seeds, device) -> list[torch.Generator]:
    """One torch.Generator per variant, seeded from an int."""
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def projector_params(beams: Tensor, analytic: bool = True) -> dict:
    """The projector entries of one beam pattern, shared by every variant:
    the analytic beam-splat entries, or the rasterized texture
    (`bench.py:146-156`: summed splats, no blur)."""
    if analytic:
        return laser.rays_to_beam_params(beams, PROJECTOR_FOV, sigma=BEAM_SIGMA,
                                         texture_size=BEAM_TEXTURE)
    return {"tex.data": laser.rays_to_texture_rgb(beams, PROJECTOR_FOV, sigma=BEAM_SIGMA,
                                                  texture_size=BEAM_TEXTURE, blur_kernel=0)}


def scene_batch(bridge: SceneBridge, randomize, beams: Tensor, gens, analytic: bool = True,
                steps=None):
    """The RenderScene of one randomized variant per generator, each with
    the beam pattern's projector attached; variant i randomized at
    `steps[i]` (all at step 0 without `steps`)."""
    proj = projector_params(beams, analytic)
    steps = [0] * len(gens) if steps is None else steps
    return bridge.assemble([dict(randomize(g, s), **proj) for g, s in zip(gens, steps)])


def render_batch(bridge: SceneBridge, randomize, beams: Tensor, seeds,
                 cfg: RenderConfig, analytic: bool = True) -> Tensor:
    """Render one randomized variant per seed in one batch; (B, H, W, 3)."""
    gens = generators(seeds, beams.device)
    return render_rgb(scene_batch(bridge, randomize, beams, gens, analytic), gens, cfg)


def pattern_step(bridge: SceneBridge, randomize, beams: Tensor, seeds,
                 cfg: RenderConfig, analytic: bool = True) -> tuple[Tensor, Tensor]:
    """Loss = mean over variants of the mean image, and its gradient with
    respect to the (K, 3) beam directions: one batched render of every
    seed's variant and one backward, as the reference's value_and_grad over
    its vmapped batch (`bench.py:145-168`).  Memory holds the whole batch's
    graph."""
    beams = beams.detach().requires_grad_(True)
    img = render_batch(bridge, randomize, beams, seeds, cfg, analytic)
    loss = img.mean(dim=(1, 2, 3)).mean()
    loss.backward()
    return loss.detach(), beams.grad


def variant_loss(bridge: SceneBridge, randomize, cfg: RenderConfig, objective,
                 analytic: bool = True):
    """`optim.make_variant_loss` on this scene: loss(rays, gens, step) ->
    (B,), every generator's variant randomized at `step`, the beams'
    projector attached (`projector_params`), rendered in one batch and
    reduced by `objective` image by image."""
    return make_variant_loss(randomize, bridge.assemble,
                             lambda scene, gens: render_rgb(scene, gens, cfg), objective,
                             pattern_params_fn=lambda rays: projector_params(rays, analytic))


# The dataset farm's post-processing (bench.py's measure_datagen): a 3x3
# Gaussian blur of sigma 0.8, then a clip to [0, 1].
FARM_BLUR = ((3, 3), (0.8, 0.8))


def datagen_batch(bridge: SceneBridge, randomize, beams: Tensor, cfg: RenderConfig):
    """render_batch_fn(seeds, steps) for `datagen.generate_dataset`: frame
    i randomized from a generator seeded seeds[i] at steps[i], rendered
    with the analytic projector, blurred and clipped (FARM_BLUR), and its
    segmentation; returns (images (B, H, W, 3), segmentations (B, H, W)
    int32) on the device, without autograd."""

    def render_batch_fn(seeds, steps):
        with torch.no_grad():
            gens = generators(seeds, beams.device)
            scene = scene_batch(bridge, randomize, beams, gens, steps=steps)
            img = gaussian_blur2d(render_rgb(scene, gens, cfg), *FARM_BLUR).clamp(0.0, 1.0)
            return img, render_segmentation(scene, cfg)

    return render_batch_fn


SOFT_SIZE = 256  # the soft silhouette's film, bench.py's BENCH_SOFT_SIZE


def pose_scene(bridge: SceneBridge, randomize, beams: Tensor, delta: Tensor, seeds,
               render_seeds=None):
    """(scene, gens): the RenderScene of one randomized variant per seed
    (analytic projector) with every vertex moved by the (3,) translation
    `delta`, and the generators of its render: those of `render_seeds`
    when given, else the variants' own after their draws."""
    gens = generators(seeds, beams.device)
    scene = scene_batch(bridge, randomize, beams, gens)
    if render_seeds is not None:
        gens = generators(render_seeds, beams.device)
    geo = scene.geometry
    return scene.replace(geometry=geo.replace(vertices=geo.vertices + delta)), gens


def pose_targets(bridge: SceneBridge, randomize, beams: Tensor, seeds, cfg: RenderConfig,
                 render_seeds=None, soft_size: int = SOFT_SIZE) -> tuple[Tensor, Tensor | None]:
    """The detached targets of the pose objective at delta = 0: each seed's
    image (B, H, W, 3), its draws as `pose_scene` makes them, rendered
    without `reparam`, and its soft silhouette (B, soft_size, soft_size),
    None under `cfg.reparam` (whose objective has none)."""
    with torch.no_grad():
        zero = torch.zeros(3, device=beams.device)
        scene, gens = pose_scene(bridge, randomize, beams, zero, seeds, render_seeds)
        img = render_rgb(scene, gens, cfg.replace(reparam=False))
        mask = None if cfg.reparam else render_soft_silhouette(
            scene, cfg.replace(width=soft_size, height=soft_size))
    return img, mask


def pose_step(bridge: SceneBridge, randomize, beams: Tensor, delta: Tensor, seeds, targets,
              cfg: RenderConfig, soft_size: int = SOFT_SIZE,
              render_seeds=None) -> tuple[Tensor, Tensor]:
    """The pose objective and its gradient with respect to the (3,)
    translation `delta`, in one batched render and one backward, as the
    loss of the reference's `bench.py::_measure_pose`: `optim.hybrid_pose_loss`
    (the path-traced image's L2 against the targets' plus the soft
    silhouette's, each a mean over the batch, with one soft silhouette),
    or under `cfg.reparam` `optim.image_l2` alone (the `pose_reparam`
    row: the render's warped-area pass carries the boundary gradients).
    Variants and draws as `pose_scene` makes them.  `cfg.static_geometry`
    must be False, or the vertices get no gradient."""
    if cfg.static_geometry:
        raise ValueError("pose_step needs RenderConfig(static_geometry=False)")
    delta = delta.detach().requires_grad_(True)
    tgt_img, tgt_mask = targets
    scene, gens = pose_scene(bridge, randomize, beams, delta, seeds, render_seeds)
    img = render_rgb(scene, gens, cfg)
    if cfg.reparam:
        loss = image_l2(img, tgt_img)
    else:
        mask = render_soft_silhouette(scene, cfg.replace(width=soft_size, height=soft_size))
        loss = hybrid_pose_loss(img, tgt_img, mask, tgt_mask)
    loss.backward()
    return loss.detach(), delta.grad


MAP_SIZE = 256  # the material maps' texels a side


def material_maps(seed: int) -> dict:
    """Material maps made with numpy from `seed`, S = MAP_SIZE texels a
    side: "base" (S, S, 3) a tinted value noise in [0.2, 0.9], "rough"
    (S, S) in [0.1, 0.9], "normal" (S, S, 3) tangent-space normals tilted
    up to ~20 degrees, as RGB in [0, 1]."""
    rng = np.random.default_rng(seed)
    size = MAP_SIZE

    def noise(cells):
        coarse = rng.uniform(size=(cells + 1, cells + 1))
        x = np.linspace(0.0, cells, size)
        i = np.minimum(x.astype(int), cells - 1)
        f = x - i
        rows = coarse[i] * (1 - f)[:, None] + coarse[i + 1] * f[:, None]
        return rows[:, i] * (1 - f)[None, :] + rows[:, i + 1] * f[None, :]

    tint = rng.uniform(0.5, 1.0, size=3)
    base = (0.2 + 0.7 * noise(16)[..., None] * tint).astype(np.float32)
    rough = (0.1 + 0.8 * noise(8)).astype(np.float32)
    tilt = 0.35 * (np.stack([noise(32), noise(32)], -1) - 0.5)
    nrm = np.concatenate([tilt, np.ones((size, size, 1))], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return {"base": base, "rough": rough, "normal": (0.5 * nrm + 0.5).astype(np.float32)}


def build_materials(device="cuda", size: int = 512):
    """(bridge, randomize, beams, cfg) of the `materials` shape: the
    reference's farm scene, `vocalfold(resolution=24)` (1440 faces) with
    examples/vocalfold_scene.py's randomization (fold scale x and z in
    [1, 1.5], rotation y in [-0.2, 0.2]; clearcoat, roughness and sheen of
    mat-Mucosa each U(0, 1); the spot's intensity one U(5, 25) grey), a
    base-colour texture on mat-Mucosa (emitted as its ".base_color.data"
    key) and base-colour, roughness and normal maps on mat-Tissue
    (`material_maps`, MAP_SIZE^2).  512^2, spp 1, 2 bounces, the analytic
    projector; the maps take the face-table route."""
    scene, kw = scenes.vocalfold(resolution=24, n_anim_frames=4)
    vf = scene.mesh("mesh-Vocalfold")
    vf.scale_x(1.0, 1.5)
    vf.scale_z(1.0, 1.5)
    vf.rotate_y(-0.2, 0.2)
    mucosa = scene.material("mat-Mucosa")
    for key in ("clearcoat", "roughness", "sheen"):
        mucosa.add_float_key(key, 0.0, 1.0)
    mucosa.set_texture(material_maps(0)["base"])
    tissue = scene.material("mat-Tissue")
    maps = material_maps(1)
    tissue.set_texture(maps["base"])
    tissue.set_roughness_texture(maps["rough"])
    tissue.set_normal_texture(maps["normal"])
    scene.light("emit-Spot").add_vec3_sampler(
        "intensity.value", sampling.UniformScalarToVec3Sampler.create(5.0, 25.0))
    bridge = SceneBridge(scene, **kw)
    beams = laser.generate_uniform_rays(0.0275, 12, 12, device=device)
    return bridge, scene.compile(device=device), beams, bench_config(size=size)


ENVMAP_HW = (128, 256)


def _envmap_to_world(yaw: float, tilt: float) -> np.ndarray:
    """(4, 4) rotation: `tilt` about +X, then `yaw` about +Y."""
    cy, sy, ct, st = np.cos(yaw), np.sin(yaw), np.cos(tilt), np.sin(tilt)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                   @ np.array([[1, 0, 0], [0, ct, -st], [0, st, ct]]))
    return out


# The emitters shape's envmap orientation: the sun stays high above the
# camera's view (at most 46 degrees from the zenith).
ENVMAP_TO_WORLD = _envmap_to_world(0.6, 0.17)


def sky_envmap(hw: tuple = ENVMAP_HW) -> np.ndarray:
    """An (H, W, 3) equirectangular sky: a gradient from a pale horizon to a
    blue zenith (row 0 is +Y), a dim ground, and one bright sun texel."""
    h, w = hw
    theta = np.pi * (np.arange(h) + 0.5) / h
    up = np.clip(np.cos(theta), 0.0, 1.0)[:, None]
    sky = (1.0 - up) * np.array([1.0, 0.95, 0.85]) + up * np.array([0.25, 0.45, 0.9])
    env = np.where((theta < np.pi / 2)[:, None], sky, np.array([0.08, 0.07, 0.06]))
    env = np.repeat(env[:, None, :], w, axis=1).astype(np.float32)
    env[h // 5, (3 * w) // 8] = 400.0
    return env


def build_emitters(device="cuda", size: int = 512):
    """(bridge, randomize, beams, cfg) of the `emitters` shape: `cornell_like`
    with a glass UV sphere (`make_sphere(0.3, 48, 96)`, 9024 faces;
    spec_trans 1, thin 0, ior 1.5, roughness 0.1), the box made a thin
    translucent sheet (spec_trans 0.6, thin 1), anisotropic 0.6 on the back
    wall, flatness 0.5 on the left, a base-colour texture on the floor
    (`material_maps`), an emissive ceiling quad (emission 8: the area
    light), radius 0.05 on the point light (its aperture), and `sky_envmap`
    under ENVMAP_TO_WORLD with env_nee: 9046 faces, the
    streamed route.  512^2, spp 4, shared primary, 3 bounces.  The scene
    has no projector: `beams` only carries the device."""
    scene, kw = scenes.cornell_like()
    verts, faces, uvs = procedural.make_sphere(0.3, rings=48, segments=96)
    sphere = Mesh("mesh-sphere", verts, faces, uvs)
    sphere.set_world(ffmath.translation_matrix_np([0.55, -0.7, 0.45]))
    scene.add_mesh(sphere, material="mat-sphere")
    scene.add_material(Material("mat-sphere", base_color=(0.95, 0.95, 0.95), spec_trans=1.0,
                                thin=0.0, ior=1.5, roughness=0.1))
    box = scene.material("mat-box")
    box.set_param("spec_trans", 0.6)
    box.set_param("thin", 1.0)
    scene.material("mat-mesh-back").set_param("anisotropic", 0.6)
    scene.material("mat-mesh-left").set_param("flatness", 0.5)
    scene.material("mat-mesh-floor").set_texture(material_maps(0)["base"])
    verts, faces, uvs = procedural.make_plane(0.3, 1)
    lamp = Mesh("mesh-lamp", verts, faces, uvs)
    down = np.eye(4, dtype=np.float32)
    down[:3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]  # +Z -> -Y
    down[:3, 3] = [0.0, 0.98, -0.45]  # beside the point light, not above it
    lamp.set_world(down)
    scene.add_mesh(lamp, material="mat-lamp")
    scene.add_material(Material("mat-lamp", base_color=(0.8, 0.8, 0.8), emission=(8.0, 8.0, 8.0)))
    scene.light("light-top").add_float_sampler("radius", sampling.ConstantSampler.of(0.05))
    bridge = SceneBridge(scene, **kw, background=sky_envmap(), background_to_world=ENVMAP_TO_WORLD)
    beams = laser.generate_uniform_rays(0.0275, 12, 12, device=device)
    cfg = RenderConfig(width=size, height=size, spp=4, max_bounces=3, shared_primary=True,
                       static_geometry=True)
    return bridge, scene.compile(device=device), beams, cfg


# The vocalfold scene of `scenes.vocalfold(resolution=24)` exported by the
# JAX package's `tools/mitsuba_parity.py export`: two OBJ meshes (1152 +
# 288 faces), a spot light and the camera.
VOCALFOLD_XML = Path(__file__).resolve().parent.parent / "tools" / "parity_scenes" / "vocalfold.xml"


def _vocalfold_projector() -> Transformable:
    """`scenes.vocalfold`'s laser projector, beside the camera."""
    proj = Transformable("Projector")
    proj.set_world(ffmath.look_at_np((0.35, 0.0, 1.9), (0.0, 0.0, 0.0)))
    return proj


def shape_from_scene(scene, bridge_kwargs: dict, device="cuda", size: int = 512):
    """(bridge, randomize, beams, cfg) of a loaded scene: its SceneBridge,
    its randomize function on `device`, the (144, 3) uniform beams and
    `bench_config(size)`."""
    bridge = SceneBridge(scene, **bridge_kwargs)
    beams = laser.generate_uniform_rays(0.0275, 12, 12, device=device)
    return bridge, scene.compile(device=device), beams, bench_config(size=size)


def xml_scene(path=VOCALFOLD_XML):
    """(scene, bridge_kwargs) of the `xml` shape: the Mitsuba scene at
    `path` (`scene_from_mitsuba_xml`: meshes mesh_0 (the fold) and mesh_1,
    materials mat0 and mat1, the spot emit_0, the camera), then what a user
    adds after loading it: `scenes.vocalfold`'s projector (fov 30, scale
    20) and examples/vocalfold_scene.py's randomization (fold scale x and z
    in [1, 1.5], rotation y in [-0.2, 0.2]; clearcoat, roughness and sheen
    of mat0 each U(0, 1); the spot's intensity one U(5, 25) grey).  The
    loader binds no material to the shapes (their `<ref>`s are not
    followed), so every face takes mat0."""
    scene, kw, _ = scene_from_mitsuba_xml(path)
    scene.set_projector(_vocalfold_projector())
    kw = dict(kw, projector_fov=PROJECTOR_FOV, projector_scale=20.0)
    fold = scene.mesh("mesh_0")
    fold.scale_x(1.0, 1.5)
    fold.scale_z(1.0, 1.5)
    fold.rotate_y(-0.2, 0.2)
    for key in ("clearcoat", "roughness", "sheen"):
        scene.material("mat0").add_float_key(key, 0.0, 1.0)
    scene.light("emit_0").add_vec3_sampler(
        "intensity.value", sampling.UniformScalarToVec3Sampler.create(5.0, 25.0))
    return scene, kw


def build_xml(device="cuda", size: int = 512):
    """(bridge, randomize, beams, cfg) of the `xml` shape (`xml_scene`):
    1440 faces, 512^2, spp 1, 2 bounces, the analytic projector."""
    return shape_from_scene(*xml_scene(), device, size)


YAML_RESOLUTION, YAML_FRAMES = 24, 4
NOISE_TEXTURE = (256, 256)
NOISE_COLORS = ((1.0, 0.0, 0.0), (0.9, 0.1, 0.0))  # a red family


def yaml_description() -> dict:
    """The `yaml` shape's scene description: the camera, the vocalfold
    primitive (resolution 24) animated from the OBJ frames in frames/ and
    randomized as examples/vocalfold_scene.py does, the larynx tube, the
    two materials, the spot with a grey intensity U(5, 25) and the
    projector (`scenes.vocalfold`'s placements)."""
    return {
        "camera": {"position": [0.0, 0.0, 1.9], "look_at": [0.0, 0.0, 0.0], "up": [0.0, 1.0, 0.0],
                   "fov": 60.0},
        "meshes": [
            {"name": "mesh-Vocalfold", "primitive": "vocalfold", "resolution": YAML_RESOLUTION,
             "material": "mat-Mucosa", "animation": {"obj_dir": "frames"},
             "randomize": {"scale_x": [1.0, 1.5], "scale_z": [1.0, 1.5],
                           "rotate_y": [-0.2, 0.2]}},
            {"name": "mesh-Larynx", "primitive": "tube", "radius": 1.6, "length": 3.0,
             "position": [0.0, 0.0, 2.0], "material": "mat-Tissue"},
        ],
        "materials": [
            {"name": "mat-Mucosa", "base_color": [0.78, 0.35, 0.34], "roughness": 0.35,
             "specular": 0.6, "randomize": {k: [0.0, 1.0]
                                            for k in ("clearcoat", "roughness", "sheen")}},
            {"name": "mat-Tissue", "base_color": [0.72, 0.3, 0.3], "roughness": 0.5},
        ],
        "lights": [
            {"name": "emit-Spot", "kind": "spot", "position": [0.0, 0.0, 1.95],
             "look_at": [0.0, 0.0, 0.0], "intensity": [12.0, 12.0, 12.0], "cutoff_angle": 40.0,
             "randomize": {"intensity_scalar": [5.0, 25.0]}},
        ],
        "projector": {"position": [0.35, 0.0, 1.9], "look_at": [0.0, 0.0, 0.0],
                      "fov": PROJECTOR_FOV, "scale": 20.0},
        "background": [0.0, 0.0, 0.0],
    }


def write_yaml_scene(directory) -> Path:
    """Write the `yaml` shape's files into `directory`: scene.yml
    (`yaml_description`, by `scene_io.save_scene_description`) and its fold
    animation, `procedural.vocalfold_animation_frames(4)` less the rest
    mesh's centroid, as frames/frame_<i>.obj (`utils.io.save_obj`).
    Returns the description's path."""
    directory = Path(directory)
    verts, faces, _ = procedural.make_vocalfold(resolution=YAML_RESOLUTION)
    frames = procedural.vocalfold_animation_frames(YAML_FRAMES, resolution=YAML_RESOLUTION)
    (directory / "frames").mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(frames - verts.mean(0)):
        ffio.save_obj(directory / "frames" / f"frame_{i:03d}.obj", frame, faces)
    path = directory / "scene.yml"
    scene_io.save_scene_description(yaml_description(), path)
    return path


def yaml_scene(path):
    """(scene, bridge_kwargs) of the description at `path`
    (`scene_io.load_scene`), with a NoiseTextureLerpSampler (NOISE_TEXTURE,
    NOISE_COLORS) on the mucosa's "brdf_0.base_color.data"."""
    scene, kw = scene_io.load_scene(path)
    scene.material("mat-Mucosa").add_vec3_sampler(
        "brdf_0.base_color.data",
        sampling.NoiseTextureLerpSampler.create(*NOISE_COLORS, texture_shape=NOISE_TEXTURE))
    return scene, kw


def build_yaml(device="cuda", size: int = 512):
    """(bridge, randomize, beams, cfg) of the `yaml` shape: the files of
    `write_yaml_scene` in a temporary directory, loaded by `yaml_scene`;
    1536 faces (the tube primitive has 8 rings), 512^2, spp 1, 2 bounces,
    the analytic projector, the noise texture on the face-table route."""
    with tempfile.TemporaryDirectory() as tmp:
        return shape_from_scene(*yaml_scene(write_yaml_scene(tmp)), device, size)


BLOCKER_QUADS = np.array([
    [[-1, -1, -2], [1, -1, -2], [1, 1, -2], [-1, 1, -2]],
    [[-2, -1.2, 0], [2, -1.2, 0], [2, 1.5, 0], [-2, 1.5, 0]],
    [[-3, -4, -2.4], [3, -4, -2.4], [3, -4, -0.8], [-3, -4, -0.8]],
    [[-1, -2, -1.4], [1, -2, -1.4], [1, -2, -0.6], [-1, -2, -0.6]]], np.float32)
BLOCKER_CONFIG = RenderConfig(width=8, height=8, spp=2, max_bounces=3, reparam=True,
                              reparam_indirect=True, reparam_ind_bounces=2)


def blocker_scene(dx: torch.Tensor, device="cuda") -> RenderScene:
    """tests/test_mb3_grad_nan.py's scene, one variant per entry of dx (B,):
    camera -> wall A (z = -2) -> wall B (z = 0) -> an emissive panel
    (y = -4, emission without an area light's NEE), and a grey blocker in
    the y = -2 plane between B and the panel, moved dx along x.  Only the
    warped bounce directions of BLOCKER_CONFIG (`reparam_indirect`, the
    first two) see the blocker's edges move; d(mean red)/d(dx) at dx = 1
    is the warped-area gradient this scene checks."""
    b = dx.shape[0]
    q = torch.as_tensor(BLOCKER_QUADS, device=device)
    zero = torch.zeros_like(dx)
    blocker = q[3][None] + torch.stack([dx, zero, zero], dim=-1)[:, None]
    faces = [f for k in range(4) for f in ([4 * k, 4 * k + 1, 4 * k + 2],
                                           [4 * k, 4 * k + 2, 4 * k + 3])]
    geo = Geometry(vertices=torch.cat([q[:3].reshape(1, -1, 3).expand(b, -1, -1), blocker], 1),
                   faces=torch.tensor(faces, device=device),
                   face_mat=torch.tensor([0, 0, 0, 0, 1, 1, 0, 0], device=device),
                   face_mesh=torch.tensor([0, 0, 1, 1, 2, 2, 3, 3], device=device))
    one = torch.ones(b, 2, device=device)
    grey_and_panel = torch.tensor([[0.8] * 3, [0.0] * 3], device=device).expand(b, 2, 3)
    mats = Materials(base_color=grey_and_panel, roughness=one, metallic=0 * one,
                     specular=0 * one, spec_tint=0 * one, clearcoat=0 * one,
                     clearcoat_gloss=one, sheen=0 * one, sheen_tint=0.5 * one,
                     anisotropic=0 * one, spec_trans=0 * one, flatness=0 * one, ior=1.5 * one,
                     thin=0 * one, flags=None,
                     emission=torch.tensor([[0.0] * 3, [24.0] * 3], device=device).expand(b, 2, 3))
    lights = Lights(kinds=(), to_world=torch.zeros(b, 0, 4, 4, device=device),
                    intensity=torch.zeros(b, 0, 3, device=device),
                    cutoff_cos=torch.zeros(b, 0, device=device),
                    beam_cos=torch.zeros(b, 0, device=device),
                    active=torch.zeros(b, 0, dtype=torch.bool, device=device))
    cam = Camera(to_world=torch.eye(4, device=device)[None].expand(b, 4, 4),
                 fov=torch.full((b,), 60.0, device=device),
                 near=torch.full((b,), 0.01, device=device),
                 far=torch.full((b,), 1000.0, device=device))
    return RenderScene(geometry=geo, materials=mats, lights=lights, camera=cam)


def blocker_gradient_samples(variants: int, seed0: int = 1000, device="cuda", h: float = 0.25):
    """Samples of the blocker scene's gradient: per variant (generator
    seed0 + i), d(mean red)/d(dx) of the warped render (BLOCKER_CONFIG) at
    dx = 1, and the central difference of the plain render at 1 +- h with
    the same generators; two (variants,) numpy arrays."""
    def gens():
        return [torch.Generator(device=device).manual_seed(seed0 + i) for i in range(variants)]

    dx = torch.ones(variants, device=device, requires_grad=True)
    img = render_rgb(blocker_scene(dx, device), gens(), BLOCKER_CONFIG)
    img[..., 0].mean(dim=(1, 2)).sum().backward()
    plain = BLOCKER_CONFIG.replace(reparam=False)
    with torch.no_grad():
        up, down = (render_rgb(blocker_scene(torch.full((variants,), 1.0 + s, device=device),
                                         device), gens(), plain)[..., 0].mean(dim=(1, 2))
                    for s in (h, -h))
    return dx.grad.cpu().numpy(), ((up - down) / (2 * h)).cpu().numpy()


BUILDERS = {"materials": build_materials, "emitters": build_emitters, "xml": build_xml,
            "yaml": build_yaml}
