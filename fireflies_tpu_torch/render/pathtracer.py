"""Differentiable path tracer (port of fireflies_tpu/render/pathtracer.py).

A wavefront integrator over a batch of scene variants: every per-ray
tensor is (B, N).  Bounces are a Python loop with masked inactive rays.
Next-event estimation covers every delta emitter (point / spot / the
projector, analytic or textured) with reversed shadow rays on the
shared-origin kernel, or, for an emitter with a soft-shadow aperture, from
an origin jittered over its disk on the per-ray-origin route; an (H, W, 3)
envmap background (importance-sampled, `env_nee`) and the emissive faces
(area lights) are sampled too, each weighed against BSDF sampling by the
power heuristic, whose BSDF side reads the pdf of the ray that reached the
vertex (`prev_pdf`).  BSDF importance sampling drives the bounces.
Material maps (base colour, roughness, tangent-space normals) are looked
up at the hit's uv.  Traversal is detached and shading differentiable, so
gradients reach the projector's beam pattern, the materials and their
textures, the envmap and, on the face-table route, the vertices.

Two routes for a hit's attributes, chosen as the reference chooses them
(`kernel_attrs` in trace_rays): the static-geometry route takes positions
from t along the ray and normals and material ids from the kernels (the
vertices get no gradient); the face-table route (RenderConfig's default,
and any scene with smooth normals or material maps) re-derives position,
normal, uv, tangent and the interpolated smooth normal from one packed row
per face (intersect.hit_attributes_table), differentiably with respect to
the vertices.  Shadow rays of dead paths carry t_max = -1, which the
kernels skip.  Also ported: the default and the tile-coherent bounce
sampler (`coherent_bounce`), the spp loop, `ray_chunk`, and the shared
first vertex (`shared_primary`, `_film_render_shared`).
Reparameterization is not ported (RenderConfig refuses it).
"""

from __future__ import annotations

import math

import torch

from fireflies_tpu_torch.render import bsdf as bsdf_mod
from fireflies_tpu_torch.render import lights as lights_mod
from fireflies_tpu_torch.render.cuda.intersect_kernel import RAY_TILE
from fireflies_tpu_torch.render.intersect import (
    build_face_table,
    closest_hit,
    hit_attributes_table,
    occluded_any,
)
from fireflies_tpu_torch.render.rays import camera_rays_tiled, uniform, unpermute_rows
from fireflies_tpu_torch.render.texture import (
    bilinear_sample_stack_packed,
    pack_neighborhood_stack,
    pack_neighborhood_table,
    sample_envmap,
)
from fireflies_tpu_torch.render.types import RenderConfig, RenderScene
from fireflies_tpu_torch.render.vec3 import Vec3, from_array, splat
from fireflies_tpu_torch.render.vec3 import where as v3_where

Tensor = torch.Tensor

_SHADOW_EPS = 1e-3


def _pack_textures(scene: RenderScene) -> dict:
    """The 2x2-neighbourhood tables of every texture the trace looks up,
    packed once a render for every bounce: "proj" for the projector's
    texture, and (table, H, W) for the material maps "base", "rough" and
    "normal"."""
    packs = {}
    mats = scene.materials
    if scene.projector is not None and scene.projector.texture is not None:
        packs["proj"] = pack_neighborhood_table(scene.projector.texture)
    for key, tex in (("base", mats.textures), ("rough", mats.roughness_tex),
                     ("normal", mats.normal_tex)):
        if tex is not None:
            packs[key] = (pack_neighborhood_stack(tex), tex.shape[-3], tex.shape[-2])
    return packs


def _map_lookup(packs: dict, key: str, attrs: dict) -> Tensor:
    """Material map `key` at each hit's uv, of the hit's material; (B, N, C)."""
    table, h, w = packs[key]
    uv = torch.stack([attrs["uv_x"], attrs["uv_y"]], dim=-1)
    return bilinear_sample_stack_packed(table, h, w, attrs["mat_id"], uv)


def _has_map(has: Tensor, mat_id: Tensor) -> Tensor:
    """The (B, M) map mask at each hit's material; (B, N) bool."""
    return torch.gather(has, 1, mat_id.long())


def _shading_base_color(scene: RenderScene, params: dict, attrs: dict,
                        packs: dict | None = None) -> dict:
    """Parameter rows with base_color and roughness taken from the maps
    where the hit's material has one (needs the hit's uv)."""
    if "uv_x" not in attrs:
        return params
    packs = _pack_textures(scene) if packs is None else packs
    mats = scene.materials
    out = params
    if "base" in packs:
        has = _has_map(mats.has_texture, attrs["mat_id"])
        out = dict(out)
        out["base_color"] = torch.where(has[..., None], _map_lookup(packs, "base", attrs),
                                        out["base_color"])
        out.pop("base_color_v", None)  # the cached component form
    if "rough" in packs:
        has = _has_map(mats.has_roughness_tex, attrs["mat_id"])
        out = dict(out)
        out["roughness"] = torch.where(has, _map_lookup(packs, "rough", attrs)[..., 0],
                                       out["roughness"])
    return out


def _shading_normal(scene: RenderScene, attrs: dict, n: Vec3, packs: dict | None = None) -> Vec3:
    """Tangent-space normal mapping: ns = normalize(T x + B y + N z) with
    (x, y, z) = 2 rgb - 1, T the uv tangent made orthogonal to n, B = N x T;
    n where the material has no map, the tangent degenerates, or the mapped
    normal leaves n's hemisphere (light would pass through the surface)."""
    mats = scene.materials
    if mats.normal_tex is None or "uv_x" not in attrs or "tangent" not in attrs:
        return n
    packs = _pack_textures(scene) if packs is None else packs
    rgb = _map_lookup(packs, "normal", attrs)
    lx, ly, lz = (2.0 * rgb[..., k] - 1.0 for k in range(3))
    t_raw = attrs["tangent"]
    t = t_raw - n * t_raw.dot(n)
    # Unit tangent through Vec3.normalized, whose gradient stays finite at
    # a zero tangent (a mesh without uvs).
    ok = t.norm2() > 1e-16
    t = t.normalized()
    ns = (t * lx + n.cross(t) * ly + n * lz).normalized()
    ns = v3_where(ns.dot(n) > 1e-4, ns, n)
    return v3_where(_has_map(mats.has_normal_tex, attrs["mat_id"]) & ok, ns, n)


def coherent_uniforms(gens, n_rays: int, device) -> tuple[Tensor, ...]:
    """The bounce draws of `coherent_bounce`: each variant draws one set of
    5 uniforms (u_sel, u1, u2, u3, u4) per 2048-ray tile from its own
    generator, repeated over the tile's rays; returns 5 (B, n_rays)
    tensors.  Each ray's marginal stays U(0, 1), so the estimate stays
    unbiased, while a tile's bounce directions share one draw and its
    direction box narrows to the tile's normal spread, which the culled
    bounce kernels prune on.  `sample_v` reads u3 and u4 only for the
    transmission lobe."""
    n_tiles = -(-n_rays // RAY_TILE)
    u = uniform(gens, (5, n_tiles), device).repeat_interleave(RAY_TILE, dim=-1)[..., :n_rays]
    return tuple(u[:, k] for k in range(5))


def _sample_bounce(gens, shade: dict, throughput: Vec3, active: Tensor,
                   coherent: bool = False):
    """BSDF-sample the next path segment from a shaded vertex; returns
    (o, d, o_v, d_v, throughput, active, prev_pdf), prev_pdf the sample's
    pdf, which the next vertex's MIS weights read.  `coherent`: per-tile
    shared draws (`coherent_uniforms`) instead of one draw per ray."""
    n, ns, p = shade["n"], shade["ns"], shade["p"]
    uniforms = coherent_uniforms(gens, n.x.shape[-1], n.x.device) if coherent else None
    wi, pdf, f = bsdf_mod.sample_v(shade["params"], ns, shade["wo"], gens,
                                   tangent=shade["tangent"], uniforms=uniforms)
    cos_i_s = n.dot(wi)
    cos_i = ns.dot(wi).abs()
    weight = torch.where(pdf > 1e-6, cos_i / torch.clamp(pdf, min=1e-6), 0.0)
    throughput = throughput * f * weight
    active = active & (throughput.max_component() > 1e-5) & (pdf > 1e-6)
    side = torch.where(cos_i_s >= 0, 1.0, -1.0)
    o_v = p + n * (side * _SHADOW_EPS)
    return o_v.to_array(), wi.to_array(), o_v, wi, throughput, active, pdf


def _power_weight(p_a: Tensor, p_b: Tensor) -> Tensor:
    """Power-heuristic MIS weight of strategy a against b."""
    return (p_a * p_a) / torch.clamp(p_a * p_a + p_b * p_b, min=1e-12)


def _offset(p: Vec3, n: Vec3, toward: Tensor) -> Tensor:
    """p moved _SHADOW_EPS along n to the side where `toward` (n . dir) is
    not negative, as (B, N, 3): a shadow ray's end at the surface."""
    side = torch.where(toward >= 0, 1.0, -1.0)
    return (p + n * (side * _SHADOW_EPS)).to_array()


def trace_rays(scene: RenderScene, o: Tensor, d: Tensor, gens, config: RenderConfig,
               primary_origin: Tensor | None = None, v0_capture: dict | None = None,
               resume: dict | None = None) -> Tensor:
    """Path-trace radiance for rays o, d (B, N, 3); returns (B, N, 3).

    `gens`: one torch.Generator per variant for the bounce, aperture,
    envmap and area-light draws.  `primary_origin` (B, 3) marks the first
    bounce's rays as sharing that origin (the camera), which selects the
    shared-origin kernel.

    Shared-primary plumbing (see _film_render_shared):
      * `v0_capture` (a dict): stop once vertex 0 is shaded (its emission,
        every NEE strategy and the escape are in the returned radiance) and
        store the state that resamples the first bounce: `shade` for
        _sample_bounce, and `active`.
      * `resume`: skip vertex 0 and start the bounce loop at bounce 1 from
        the given ray state (o_v, d_v, throughput, active, prev_pdf), as
        _sample_bounce produces it.
    """
    b, n_rays, _ = o.shape
    dev = o.device
    zeros = torch.zeros((b, n_rays), device=dev)
    ones = torch.ones((b, n_rays), device=dev)
    radiance = Vec3(zeros, zeros, zeros)
    throughput = Vec3(ones, ones, ones)
    active = torch.ones((b, n_rays), dtype=torch.bool, device=dev)
    o_v, d_v = from_array(o), from_array(d)
    geo, mats = scene.geometry, scene.materials
    # Escape radiance: a constant (3,), or an (H, W, 3) envmap looked up by
    # direction, pulled into its frame by background_to_world's rotation.
    env_tex = scene.background if scene.background is not None and scene.background.dim() == 3 \
        else None
    background = splat(scene.background if scene.background is not None and env_tex is None
                       else torch.zeros(3, device=dev))
    env_rot = (scene.background_to_world[:3, :3]
               if env_tex is not None and scene.background_to_world is not None else None)
    env_dist = (lights_mod.envmap_distribution(env_tex)
                if env_tex is not None and config.env_nee else None)
    has_area = geo.emissive_faces is not None
    has_uvs, has_normals = geo.uvs is not None, geo.normals is not None
    packs = _pack_textures(scene)
    # Attributes straight from the kernels only where nothing needs an
    # interpolated per-vertex quantity: static geometry, flat shading, no
    # material maps (they read uvs), and no uvs or no anisotropic lobe (the
    # uv tangent orients it).
    flags = mats.flags
    aniso_on = flags is None or "aniso" in flags
    kernel_attrs = (config.static_geometry and not has_normals
                    and not any(k in packs for k in ("base", "rough", "normal"))
                    and not (has_uvs and aniso_on))
    face_table = None if kernel_attrs else build_face_table(geo)
    positions = lights_mod.emitter_positions(scene.lights, scene.projector)
    apertures = lights_mod.emitter_apertures(scene.lights, scene.projector)
    prev_pdf = zeros  # the BSDF pdf of the ray that reached the vertex
    start_bounce = 0
    if resume is not None:
        o_v, d_v = resume["o_v"], resume["d_v"]
        o, d = o_v.to_array().detach(), d_v.to_array().detach()
        throughput, active, prev_pdf = resume["throughput"], resume["active"], resume["prev_pdf"]
        start_bounce = 1

    for bounce in range(start_bounce, config.max_bounces):
        # Dead-ray gating: retired paths carry t_max = -1, which the kernels
        # skip (all-dead tiles skip their cluster loops).
        if bounce == 0:
            hit = closest_hit(o, d, geo, shared_origin=primary_origin, emit_attrs=kernel_attrs,
                              tile_cull=config.tile_cull)
        else:
            tmax_b = torch.where(active, 1e30, -1.0)
            hit = closest_hit(o, d, geo, t_max=tmax_b, emit_attrs=kernel_attrs,
                              tile_cull=config.tile_cull)

        escaped = active & ~hit.valid
        w_esc = 1.0
        if env_tex is not None:
            ex, ey, ez = d_v
            if env_rot is not None:  # R^T d
                r = env_rot
                ex, ey, ez = (r[0, 0] * ex + r[1, 0] * ey + r[2, 0] * ez,
                              r[0, 1] * ex + r[1, 1] * ey + r[2, 1] * ez,
                              r[0, 2] * ex + r[1, 2] * ey + r[2, 2] * ez)
            bg = from_array(sample_envmap(env_tex, ex, ey, ez))
            if env_dist is not None and bounce > 0:
                # A BSDF-sampled escape against the envmap NEE of the vertex
                # before; bounce 0 has no competitor.
                w_esc = _power_weight(prev_pdf, lights_mod.envmap_pdf_of_dir(env_dist, ex, ey, ez))
        else:
            bg = background
        radiance = radiance + throughput * bg * torch.where(escaped, w_esc, 0.0)
        active = active & hit.valid

        if kernel_attrs:
            attrs = {"position": o_v + d_v * hit.t,
                     "normal": Vec3(hit.nx, hit.ny, hit.nz).normalized(), "mat_id": hit.mat}
        else:
            attrs = hit_attributes_table(o_v, d_v, hit, face_table, has_uvs, has_normals)
        p, n_geo = attrs["position"], attrs["normal"]
        flip = torch.sign(-n_geo.dot(d_v))
        flip = torch.where(flip == 0, 1.0, flip)
        n = n_geo * flip
        wo = -d_v

        params = bsdf_mod.gather_params(mats, attrs["mat_id"])
        # Sidedness of the glass lobe: entering on front-face hits (ior),
        # exiting on back-face hits (1 / ior).
        params["eta_rel"] = torch.where(
            flip > 0, params["ior"], 1.0 / torch.clamp(params["ior"], min=1e-3))
        params = _shading_base_color(scene, params, attrs, packs)
        tangent = attrs.get("tangent")
        # Shading normal: the interpolated vertex normal where the mesh is
        # smooth, kept in the geometric hemisphere so that grazing
        # interpolation cannot let light through the surface; normal maps
        # perturb it.
        if "smooth_normal" in attrs:
            n_sm = attrs["smooth_normal"] * flip
            n_base = v3_where(n_sm.dot(n) > 1e-4, n_sm, n)
        else:
            n_base = n
        ns = _shading_normal(scene, attrs, n_base, packs)

        # Emission on any hit; a BSDF-sampled hit on an area light weighed
        # against that light's NEE at the vertex before.
        w_emit = 1.0
        if has_area and bounce > 0:
            pdf_area_hit = lights_mod.area_pdf_of_hit(geo, hit.prim)
            cos_l_hit = n_geo.dot(d_v).abs()
            pdf_solid_hit = pdf_area_hit * (hit.t * hit.t) / torch.clamp(cos_l_hit, min=1e-6)
            w_emit = torch.where(pdf_solid_hit > 0, _power_weight(prev_pdf, pdf_solid_hit), 1.0)
        emission = bsdf_mod._colv(params, "emission")
        radiance = radiance + throughput * emission * torch.where(active, w_emit, 0.0)

        # ---- next-event estimation over every delta emitter --------------
        wi_list, _dist_list, rad_list = lights_mod.total_incident_v(
            scene.lights, scene.projector, p, proj_tex_table=packs.get("proj"))
        for li, (wi_l, rad_l) in enumerate(zip(wi_list, rad_list)):
            lit = (rad_l.max_component() > 0.0) & active
            shadow_o = _offset(p, n, n.dot(wi_l))
            tmax_l = torch.where(lit, 1.0 - 1e-4, -1.0)
            if apertures[li] is not None:
                # Visibility averaged over the emitter's disk: one jittered
                # origin a shadow ray (radiance keeps the delta model); the
                # origins differ, so the per-ray-origin route.
                radius_a, ax_a, ay_a = apertures[li]
                u_ap = uniform(gens, (2, n_rays), dev)
                rr = torch.sqrt(u_ap[:, 0]) * radius_a[:, None]
                th = (2.0 * math.pi) * u_ap[:, 1]
                light_o = (positions[li][:, None, :] + (rr * torch.cos(th))[..., None]
                           * ax_a[:, None, :] + (rr * torch.sin(th))[..., None] * ay_a[:, None, :])
                blocked = occluded_any(light_o.detach(), (shadow_o - light_o).detach(), geo,
                                       t_min=1e-4, t_max=tmax_l, tile_cull=config.tile_cull)
            else:
                # Shadow segments reversed (light -> surface) so every ray of
                # a variant shares the light's origin; t in (eps, 1 - eps).
                seg_d = (shadow_o - positions[li][:, None, :]).detach()
                blocked = occluded_any(shadow_o.detach(), seg_d, geo, t_min=1e-4, t_max=tmax_l,
                                       shared_origin=positions[li].detach(),
                                       tile_cull=config.tile_cull)
            f = bsdf_mod.evaluate_v(params, ns, wo, wi_l, tangent=tangent)
            cos_i = ns.dot(wi_l).abs()
            radiance = radiance + throughput * f * rad_l * torch.where(lit & ~blocked, cos_i, 0.0)

        # ---- envmap NEE ------------------------------------------------------
        if env_dist is not None:
            wi_env, pdf_env = lights_mod.sample_envmap_nee(env_dist, n_rays, gens)
            # Radiance looked up in the envmap's frame (as the escape's), the
            # direction rotated to the world for shading and occlusion.
            rad_e = from_array(sample_envmap(env_tex, wi_env.x, wi_env.y, wi_env.z))
            if env_rot is not None:
                r = env_rot
                wi_e = Vec3(r[0, 0] * wi_env.x + r[0, 1] * wi_env.y + r[0, 2] * wi_env.z,
                            r[1, 0] * wi_env.x + r[1, 1] * wi_env.y + r[1, 2] * wi_env.z,
                            r[2, 0] * wi_env.x + r[2, 1] * wi_env.y + r[2, 2] * wi_env.z)
            else:
                wi_e = wi_env
            gate_e = active & (rad_e.max_component() > 0) & (pdf_env > 1e-12)
            blocked_e = occluded_any(_offset(p, n, n.dot(wi_e)).detach(),
                                     wi_e.to_array().detach(), geo, t_min=1e-4,
                                     t_max=torch.where(gate_e, 1e30, -1.0),
                                     tile_cull=config.tile_cull)
            f_env = bsdf_mod.evaluate_v(params, ns, wo, wi_e, tangent=tangent)
            p_b_env = bsdf_mod.pdf_v(params, ns, wo, wi_e, tangent=tangent)
            cos_e = ns.dot(wi_e).abs()
            scale_e = torch.where(gate_e & ~blocked_e, cos_e / torch.clamp(pdf_env, min=1e-12)
                                  * _power_weight(pdf_env, p_b_env), 0.0)
            radiance = radiance + throughput * f_env * rad_e * scale_e

        # ---- area-light NEE (emissive faces) --------------------------------
        if has_area:
            x_l_a, n_l_a, le_a, pdf_area = lights_mod.sample_area_light(geo, mats, p.to_array(),
                                                                        gens)
            x_l, n_l, le = from_array(x_l_a), from_array(n_l_a), from_array(le_a)
            shadow_o_a = _offset(p, n, n.dot(x_l - p))
            seg_v = x_l - from_array(shadow_o_a)
            d2 = torch.clamp(seg_v.norm2(), min=1e-12)
            wi_a = seg_v * (1.0 / torch.sqrt(d2))
            cos_s = ns.dot(wi_a).abs()
            cos_l = n_l.dot(wi_a).abs()
            # The segment stops just short of the emitter's face.
            gate_a = active & (cos_s > 0) & (le.max_component() > 0)
            blocked_a = occluded_any(shadow_o_a.detach(), (x_l_a - shadow_o_a).detach(), geo,
                                     t_min=1e-4, t_max=torch.where(gate_a, 1.0 - 1e-3, -1.0),
                                     tile_cull=config.tile_cull)
            f_a = bsdf_mod.evaluate_v(params, ns, wo, wi_a, tangent=tangent)
            pdf_solid = pdf_area * d2 / torch.clamp(cos_l, min=1e-6)
            p_b = bsdf_mod.pdf_v(params, ns, wo, wi_a, tangent=tangent)
            scale_a = torch.where(gate_a & ~blocked_a, cos_s / torch.clamp(pdf_solid, min=1e-12)
                                  * _power_weight(pdf_solid, p_b), 0.0)
            radiance = radiance + throughput * f_a * le * scale_a

        shade = dict(params=params, ns=ns, n=n, wo=wo, p=p, tangent=tangent)
        if v0_capture is not None and bounce == 0:
            v0_capture.update(shade=shade, active=active)
            return radiance.to_array()
        if bounce + 1 < config.max_bounces:
            o, d, o_v, d_v, throughput, active, prev_pdf = _sample_bounce(
                gens, shade, throughput, active, config.coherent_bounce)
            o, d = o.detach(), d.detach()
    return radiance.to_array()


def _film_render(scene: RenderScene, gens, config: RenderConfig) -> Tensor:
    """One sample per pixel; (B, H*W, 3) in row-major pixel order.  With
    `ray_chunk` below the film's ray count, the tile-major rays are padded
    (o = 0, d = 1) to whole chunks, traced chunk after chunk (each variant's
    generator draws on from one chunk to the next) and sliced back."""
    o, d, inv_perm = camera_rays_tiled(scene.camera, config.width, config.height, gens=gens)
    cam = scene.camera.to_world[:, :3, 3]
    n, chunk = o.shape[1], config.ray_chunk
    if chunk and chunk < n:
        pad = -n % chunk
        if pad:
            o = torch.cat([o, o.new_zeros(o.shape[0], pad, 3)], dim=1)
            d = torch.cat([d, d.new_ones(d.shape[0], pad, 3)], dim=1)
        radiance = torch.cat([
            trace_rays(scene, o[:, c0:c0 + chunk], d[:, c0:c0 + chunk], gens, config,
                       primary_origin=cam)
            for c0 in range(0, n + pad, chunk)], dim=1)[:, :n]
    else:
        radiance = trace_rays(scene, o, d, gens, config, primary_origin=cam)
    return unpermute_rows(radiance, inv_perm, config.width, config.height)


def _film_render_shared(scene: RenderScene, gens, config: RenderConfig) -> Tensor:
    """All spp samples with the first path vertex shared; (B, H*W, 3) in
    row-major pixel order.

    Vertex 0 (the primary hit, its attributes and every NEE strategy with
    its shadow rays) is traced once (`v0_capture`); each spp sample then
    resamples the first bounce (_sample_bounce) and traces the remaining
    vertices (`resume`).  One pixel jitter and one set of vertex-0
    aperture, envmap and area-light draws are shared by all samples, so spp
    averages the bounce randomness only; each pixel's estimate stays
    unbiased.
    """
    o, d, inv_perm = camera_rays_tiled(scene.camera, config.width, config.height, gens=gens)
    cap: dict = {}
    total = trace_rays(scene, o, d, gens, config, primary_origin=scene.camera.to_world[:, :3, 3],
                       v0_capture=cap)
    if config.max_bounces > 1:
        ones = torch.ones_like(cap["active"], dtype=torch.float32)
        rest = None
        for _ in range(config.spp):
            o2, d2, o_v2, d_v2, thr, act, ppdf = _sample_bounce(
                gens, cap["shade"], Vec3(ones, ones, ones), cap["active"],
                config.coherent_bounce)
            sample = trace_rays(scene, o2, d2, gens, config,
                                resume=dict(o_v=o_v2, d_v=d_v2, throughput=thr, active=act,
                                            prev_pdf=ppdf))
            rest = sample if rest is None else rest + sample
        total = total + rest / config.spp
    return unpermute_rows(total, inv_perm, config.width, config.height)


def render_rgb(scene: RenderScene, gens, config: RenderConfig) -> Tensor:
    """Monte-Carlo RGB render of every variant, (B, H, W, 3).  `gens`: one
    torch.Generator per variant (pixel jitter and bounce draws).  With
    `shared_primary` (and no `ray_chunk`) the first vertex is shared by the
    spp samples (_film_render_shared); otherwise the spp samples are a
    Python loop of whole passes."""
    if config.shared_primary and not config.ray_chunk:
        img = _film_render_shared(scene, gens, config)
        return img.reshape(scene.batch, config.height, config.width, 3)
    total = None
    for _ in range(config.spp):
        img = _film_render(scene, gens, config)
        total = img if total is None else total + img
    return (total / config.spp).reshape(scene.batch, config.height, config.width, 3)
