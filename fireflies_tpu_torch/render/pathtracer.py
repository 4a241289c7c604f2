"""Differentiable path tracer (port of fireflies_tpu/render/pathtracer.py).

A wavefront integrator over a batch of scene variants: every per-ray
tensor is (B, N).  Bounces are a Python loop with masked inactive rays;
next-event estimation covers every delta emitter (point / spot / analytic
projector) with reversed shadow rays on the shared-origin kernel; BSDF
importance sampling drives the bounces.  Traversal is detached and
shading differentiable, so gradients reach the projector's beam pattern.

Ported: the static-geometry route (positions from t along the ray,
normals and material ids from the hit), delta-emitter NEE with dead-ray
gating, the default and the tile-coherent bounce sampler
(`coherent_bounce`), the spp loop, and the shared first vertex
(`shared_primary`, `_film_render_shared`).  Not ported yet:
reparameterization, `ray_chunk`, envmap and area-light NEE, textures and
smooth normals (these raise).
"""

from __future__ import annotations

import torch

from fireflies_tpu_torch.render import bsdf as bsdf_mod
from fireflies_tpu_torch.render import lights as lights_mod
from fireflies_tpu_torch.render.cuda.intersect_kernel import RAY_TILE
from fireflies_tpu_torch.render.intersect import closest_hit, occluded_any
from fireflies_tpu_torch.render.rays import camera_rays_tiled, uniform, unpermute_rows
from fireflies_tpu_torch.render.types import RenderConfig, RenderScene
from fireflies_tpu_torch.render.vec3 import Vec3, from_array, splat

Tensor = torch.Tensor

_SHADOW_EPS = 1e-3


def _check_supported(scene: RenderScene, config: RenderConfig) -> None:
    geo = scene.geometry
    if not config.static_geometry:
        raise NotImplementedError(
            "only RenderConfig(static_geometry=True) is ported (kernel hit attributes)")
    if geo.normals is not None or geo.emissive_faces is not None:
        raise NotImplementedError("smooth normals and area lights are not ported")
    if scene.background is not None and scene.background.dim() != 1:
        raise NotImplementedError("envmap backgrounds are not ported")
    if any(a is not None for a in lights_mod.emitter_apertures(scene.lights, scene.projector)):
        raise NotImplementedError("soft-shadow emitter apertures are not ported")


def coherent_uniforms(gens, n_rays: int, device) -> tuple[Tensor, ...]:
    """The bounce draws of `coherent_bounce`: each variant draws one set of
    5 uniforms (u_sel, u1, u2, u3, u4) per 2048-ray tile from its own
    generator, repeated over the tile's rays; returns 5 (B, n_rays)
    tensors.  Each ray's marginal stays U(0, 1), so the estimate stays
    unbiased, while a tile's bounce directions share one draw and its
    direction box narrows to the tile's normal spread, which the culled
    bounce kernels prune on.  The port's `sample_v` reads the first three
    (u3, u4 serve lobes that are not ported)."""
    n_tiles = -(-n_rays // RAY_TILE)
    u = uniform(gens, (5, n_tiles), device).repeat_interleave(RAY_TILE, dim=-1)[..., :n_rays]
    return tuple(u[:, k] for k in range(5))


def _sample_bounce(gens, shade: dict, throughput: Vec3, active: Tensor,
                   coherent: bool = False):
    """BSDF-sample the next path segment from a shaded vertex; returns
    (o, d, o_v, d_v, throughput, active).  `coherent`: per-tile shared
    draws (`coherent_uniforms`) instead of one draw per ray."""
    n, ns, p = shade["n"], shade["ns"], shade["p"]
    uniforms = coherent_uniforms(gens, n.x.shape[-1], n.x.device) if coherent else None
    wi, pdf, f = bsdf_mod.sample_v(shade["params"], ns, shade["wo"], gens, uniforms=uniforms)
    cos_i_s = n.dot(wi)
    cos_i = ns.dot(wi).abs()
    weight = torch.where(pdf > 1e-6, cos_i / torch.clamp(pdf, min=1e-6), 0.0)
    throughput = throughput * f * weight
    active = active & (throughput.max_component() > 1e-5) & (pdf > 1e-6)
    side = torch.where(cos_i_s >= 0, 1.0, -1.0)
    o_v = p + n * (side * _SHADOW_EPS)
    return o_v.to_array(), wi.to_array(), o_v, wi, throughput, active


def trace_rays(scene: RenderScene, o: Tensor, d: Tensor, gens, config: RenderConfig,
               primary_origin: Tensor | None = None, v0_capture: dict | None = None,
               resume: dict | None = None) -> Tensor:
    """Path-trace radiance for rays o, d (B, N, 3); returns (B, N, 3).

    `gens`: one torch.Generator per variant for the bounce draws.
    `primary_origin` (B, 3) marks the first bounce's rays as sharing that
    origin (the camera), which selects the shared-origin kernel.

    Shared-primary plumbing (see _film_render_shared):
      * `v0_capture` (a dict): stop once vertex 0 is shaded (its emission,
        NEE and escape are in the returned radiance) and store the state
        that resamples the first bounce: `shade` for _sample_bounce, and
        `active`.
      * `resume`: skip vertex 0 and start the bounce loop at bounce 1 from
        the given ray state (o_v, d_v, throughput, active), as
        _sample_bounce produces it.
    """
    _check_supported(scene, config)
    b, n_rays, _ = o.shape
    dev = o.device
    zeros = torch.zeros((b, n_rays), device=dev)
    ones = torch.ones((b, n_rays), device=dev)
    radiance = Vec3(zeros, zeros, zeros)
    throughput = Vec3(ones, ones, ones)
    active = torch.ones((b, n_rays), dtype=torch.bool, device=dev)
    background = splat(scene.background if scene.background is not None
                       else torch.zeros(3, device=dev))
    o_v, d_v = from_array(o), from_array(d)
    geo = scene.geometry
    positions = lights_mod.emitter_positions(scene.lights, scene.projector)
    start_bounce = 0
    if resume is not None:
        o_v, d_v = resume["o_v"], resume["d_v"]
        o, d = o_v.to_array().detach(), d_v.to_array().detach()
        throughput, active = resume["throughput"], resume["active"]
        start_bounce = 1

    for bounce in range(start_bounce, config.max_bounces):
        # Dead-ray gating: retired paths carry t_max = -1, which the kernels
        # skip (all-dead tiles skip their cluster loops).
        if bounce == 0:
            hit = closest_hit(o, d, geo, shared_origin=primary_origin, emit_attrs=True,
                              tile_cull=config.tile_cull)
        else:
            tmax_b = torch.where(active, 1e30, -1.0)
            hit = closest_hit(o, d, geo, t_max=tmax_b, emit_attrs=True,
                              tile_cull=config.tile_cull)

        escaped = active & ~hit.valid
        radiance = radiance + throughput * background * torch.where(escaped, 1.0, 0.0)
        active = active & hit.valid

        p = o_v + d_v * hit.t
        n_geo = Vec3(hit.nx, hit.ny, hit.nz).normalized()
        flip = torch.sign(-n_geo.dot(d_v))
        flip = torch.where(flip == 0, 1.0, flip)
        n = n_geo * flip
        ns = n
        wo = -d_v

        params = bsdf_mod.gather_params(scene.materials, hit.mat)
        params["eta_rel"] = torch.where(
            flip > 0, params["ior"], 1.0 / torch.clamp(params["ior"], min=1e-3))
        emission = bsdf_mod._colv(params, "emission")
        radiance = radiance + throughput * emission * torch.where(active, 1.0, 0.0)

        # ---- next-event estimation over every delta emitter --------------
        wi_list, _dist_list, rad_list = lights_mod.total_incident_v(
            scene.lights, scene.projector, p)
        for li, (wi_l, rad_l) in enumerate(zip(wi_list, rad_list)):
            lit = (rad_l.max_component() > 0.0) & active
            side_l = torch.where(n.dot(wi_l) >= 0, 1.0, -1.0)
            shadow_o = (p + n * (side_l * _SHADOW_EPS)).to_array()
            # Shadow segments reversed (light -> surface) so every ray of a
            # variant shares the light's origin; t in (eps, 1 - eps).
            seg_d = (shadow_o - positions[li][:, None, :]).detach()
            tmax_l = torch.where(lit, 1.0 - 1e-4, -1.0)
            blocked = occluded_any(shadow_o.detach(), seg_d, geo, t_min=1e-4, t_max=tmax_l,
                                   shared_origin=positions[li].detach(),
                                   tile_cull=config.tile_cull)
            f = bsdf_mod.evaluate_v(params, ns, wo, wi_l)
            cos_i = ns.dot(wi_l).abs()
            radiance = radiance + throughput * f * rad_l * torch.where(lit & ~blocked, cos_i, 0.0)

        shade = dict(params=params, ns=ns, n=n, wo=wo, p=p)
        if v0_capture is not None and bounce == 0:
            v0_capture.update(shade=shade, active=active)
            return radiance.to_array()
        if bounce + 1 < config.max_bounces:
            o, d, o_v, d_v, throughput, active = _sample_bounce(
                gens, shade, throughput, active, config.coherent_bounce)
            o, d = o.detach(), d.detach()
    return radiance.to_array()


def _film_render(scene: RenderScene, gens, config: RenderConfig) -> Tensor:
    """One sample per pixel; (B, H*W, 3) in row-major pixel order."""
    o, d, inv_perm = camera_rays_tiled(scene.camera, config.width, config.height, gens=gens)
    radiance = trace_rays(scene, o, d, gens, config,
                          primary_origin=scene.camera.to_world[:, :3, 3])
    return unpermute_rows(radiance, inv_perm, config.width, config.height)


def _film_render_shared(scene: RenderScene, gens, config: RenderConfig) -> Tensor:
    """All spp samples with the first path vertex shared; (B, H*W, 3) in
    row-major pixel order.

    Vertex 0 (the primary hit, its attributes and every delta-emitter NEE
    with its shadow rays) does not depend on the sample for delta emitters
    under a fixed camera, so it is traced once (`v0_capture`); each spp
    sample then resamples the first bounce (_sample_bounce) and traces the
    remaining vertices (`resume`).  One pixel jitter is shared by all
    samples, so spp averages the bounce randomness only; each pixel's
    estimate stays unbiased.
    """
    o, d, inv_perm = camera_rays_tiled(scene.camera, config.width, config.height, gens=gens)
    cap: dict = {}
    total = trace_rays(scene, o, d, gens, config, primary_origin=scene.camera.to_world[:, :3, 3],
                       v0_capture=cap)
    if config.max_bounces > 1:
        ones = torch.ones_like(cap["active"], dtype=torch.float32)
        rest = None
        for _ in range(config.spp):
            o2, d2, o_v2, d_v2, thr, act = _sample_bounce(
                gens, cap["shade"], Vec3(ones, ones, ones), cap["active"],
                config.coherent_bounce)
            sample = trace_rays(scene, o2, d2, gens, config,
                                resume=dict(o_v=o_v2, d_v=d_v2, throughput=thr, active=act))
            rest = sample if rest is None else rest + sample
        total = total + rest / config.spp
    return unpermute_rows(total, inv_perm, config.width, config.height)


def render_rgb(scene: RenderScene, gens, config: RenderConfig) -> Tensor:
    """Monte-Carlo RGB render of every variant, (B, H, W, 3).  `gens`: one
    torch.Generator per variant (pixel jitter and bounce draws).  With
    `shared_primary` the first vertex is shared by the spp samples
    (_film_render_shared); otherwise the spp samples are a Python loop of
    whole passes."""
    if config.shared_primary:
        img = _film_render_shared(scene, gens, config)
        return img.reshape(scene.batch, config.height, config.width, 3)
    total = None
    for _ in range(config.spp):
        img = _film_render(scene, gens, config)
        total = img if total is None else total + img
    return (total / config.spp).reshape(scene.batch, config.height, config.width, 3)
