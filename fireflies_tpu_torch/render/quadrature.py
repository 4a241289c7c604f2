"""Deterministic quadrature transport integrator, the second witness (port
of fireflies_tpu/render/quadrature.py).

Two independent implementations of scene transport that agree within
their noise: this module shares no estimator code with
render/pathtracer.py (no NEE sampling, no MIS, no BSDF importance sampling,
no random draws):

  * primary hits by the brute-force reference intersector
    (`intersect.intersect_brute`, plain PyTorch, no kernel);
  * direct lighting from delta emitters evaluated exactly (intensity / r^2,
    spot falloff) with brute-force segment visibility;
  * indirect transport by product Gauss-Legendre quadrature over the upper
    hemisphere (mu = cos(theta) nodes x uniform phi nodes), recursively to
    `max_bounces` path vertices.

What it shares with the path tracer is the pure BSDF evaluation
(`bsdf.evaluate_v`) and the geometry, the inputs under test rather than
the estimator.  Its only error is quadrature truncation, set by n_mu and
n_phi.  Every tensor carries the variant axis: rays (B, N, 3).  The node
fan-out multiplies the rays by n_mu * n_phi a bounce, so the brute-force
scans run on ray chunks of `_RAY_CHUNK`.
"""

from __future__ import annotations

import numpy as np
import torch

from fireflies_tpu_torch.render import bsdf as bsdf_mod
from fireflies_tpu_torch.render.intersect import intersect_brute
from fireflies_tpu_torch.render.types import LIGHT_SPOT, RenderScene
from fireflies_tpu_torch.render.vec3 import Vec3, from_array, splat

Tensor = torch.Tensor

_EPS = 1e-3  # shadow and bounce origin offset (pathtracer._SHADOW_EPS)
_RAY_CHUNK = 1 << 16  # rays a brute-force scan takes at once


def _check_supported(scene: RenderScene) -> None:
    if scene.geometry.emissive_faces is not None:
        raise NotImplementedError("quadrature witness: area lights")
    if scene.background is not None and scene.background.dim() >= 3:
        raise NotImplementedError("quadrature witness: envmap background")
    if scene.projector is not None:
        raise NotImplementedError("quadrature witness: projector")


def _brute(scene: RenderScene, o: Tensor, d: Tensor, t_min: float, t_max: float):
    """(t, prim, valid) of intersect_brute over (B, N) rays, a chunk of
    rays at a time."""
    outs = [intersect_brute(o[:, i:i + _RAY_CHUNK], d[:, i:i + _RAY_CHUNK], scene.geometry,
                            t_min=t_min, t_max=t_max)
            for i in range(0, o.shape[1], _RAY_CHUNK)]
    return (torch.cat([h.t for h in outs], dim=1), torch.cat([h.prim for h in outs], dim=1),
            torch.cat([h.valid for h in outs], dim=1))


def _face_normal_mat(scene: RenderScene, prim: Tensor):
    """Geometric normal normalize(e1 x e2) and material id of each hit,
    straight from the triangle soup (not pathtracer's hit attributes)."""
    geo = scene.geometry
    idx = prim.clamp(min=0).long()
    f = geo.faces[idx]  # (B, N, 3)
    rows = torch.arange(prim.shape[0], device=prim.device)[:, None]
    v0 = geo.vertices[rows, f[..., 0]]
    e1 = geo.vertices[rows, f[..., 1]] - v0
    e2 = geo.vertices[rows, f[..., 2]] - v0
    n = torch.linalg.cross(e1, e2)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-20)
    return from_array(n), geo.face_mat[idx]


def _segment_blocked(scene: RenderScene, o: Tensor, seg: Tensor) -> Tensor:
    """Is the open segment o -> o + seg blocked?  A brute-force closest hit
    with the segment parameter in (1e-4, 1 - 1e-4)."""
    return _brute(scene, o, seg, 1e-4, 1.0 - 1e-4)[2]


def _direct_delta(scene: RenderScene, p: Vec3, ns: Vec3, wo: Vec3, params: dict,
                  n_geo: Vec3) -> Vec3:
    """Exact direct lighting from every delta emitter (point and spot):
    f * (intensity / r^2) * falloff * |cos| * V, written from the emitter
    model's definition, not from lights.py's NEE."""
    lights = scene.lights
    zeros = torch.zeros_like(p.x)
    out = Vec3(zeros, zeros, zeros)
    for li in range(lights.count if lights is not None else 0):
        to_world = lights.to_world[:, li]  # (B, 4, 4)
        pos = to_world[:, :3, 3]
        delta = splat(pos) - p
        dist = delta.norm()
        wi = delta * (1.0 / (dist + 1e-20))
        rad = splat(lights.intensity[:, li]) * (1.0 / torch.clamp(dist * dist, min=1e-12))
        if lights.kinds[li] == LIGHT_SPOT:
            # Smooth edge between beam and cutoff angles, measured from the
            # emitter's -Z axis.
            cos_angle = (-wi).dot(splat(-to_world[:, :3, 2]))
            cutoff_c, beam_c = lights.cutoff_cos[:, li, None], lights.beam_cos[:, li, None]
            falloff = torch.clamp((cos_angle - cutoff_c)
                                  / torch.clamp(beam_c - cutoff_c, min=1e-6), 0.0, 1.0)
        else:
            falloff = torch.ones_like(dist)
        scale = torch.where(lights.active[:, li, None], falloff, 0.0)

        # Visibility of the segment from the offset surface point to the light.
        side = torch.where(n_geo.dot(wi) >= 0, 1.0, -1.0)
        shadow_o = (p + n_geo * (side * _EPS)).to_array()
        blocked = _segment_blocked(scene, shadow_o, pos[:, None, :] - shadow_o)

        f = bsdf_mod.evaluate_v(params, ns, wo, wi)
        cos_i = ns.dot(wi).abs()
        out = out + f * rad * (torch.where(blocked, 0.0, cos_i) * scale)
    return out


def _gauss_mu_phi(n_mu: int, n_phi: int, device):
    """Product-rule nodes and weights of the hemisphere integral
    int g(wi) dwi = int_0^{2 pi} int_0^1 g(mu, phi) dmu dphi (mu = cos theta)."""
    x, w = np.polynomial.legendre.leggauss(n_mu)  # over [-1, 1]
    mu = 0.5 * (x + 1.0)
    w_mu = 0.5 * w
    phi = (np.arange(n_phi) + 0.5) * (2.0 * np.pi / n_phi)
    w_phi = np.full(n_phi, 2.0 * np.pi / n_phi)
    mu_g, phi_g = np.meshgrid(mu, phi, indexing="ij")
    return tuple(torch.tensor(a.ravel(), dtype=torch.float32, device=device)
                 for a in (mu_g, phi_g, np.outer(w_mu, w_phi)))


def _onb(n: Vec3) -> tuple[Vec3, Vec3]:
    """Branchless orthonormal basis (Duff et al. 2017), the witness's own
    copy, so that it does not lean on bsdf's frame helpers."""
    s = torch.where(n.z >= 0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    t = Vec3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    bt = Vec3(b, s + n.y * n.y * a, -n.y)
    return t, bt


def _repeat(x, k: int):
    """Each point's entry k times over, along the ray axis (dim 1)."""
    if isinstance(x, Vec3):
        return Vec3(*(_repeat(c, k) for c in x))
    if isinstance(x, Tensor) and x.dim() >= 2:
        return x.repeat_interleave(k, dim=1)
    return x  # the scene-static lobe flags


def radiance_quadrature(scene: RenderScene, o: Tensor, d: Tensor, max_bounces: int = 2,
                        n_mu: int = 24, n_phi: int = 48) -> Tensor:
    """Deterministic radiance of rays o, d (B, N, 3) -> (B, N, 3).

    The path tracer's transport (emission at every vertex, direct delta
    lighting at every vertex, BSDF transport between vertices, a constant
    background on escape) with quadrature in place of Monte Carlo.  Delta
    lights and a constant background only; raises NotImplementedError on
    area lights, an envmap or a projector.
    """
    _check_supported(scene)
    dev = o.device
    bg = splat(torch.zeros(3, device=dev) if scene.background is None
               else scene.background.to(device=dev, dtype=torch.float32))
    mu, phi, w_q = _gauss_mu_phi(n_mu, n_phi, dev)
    n_dirs = mu.shape[0]

    def level(o_a: Tensor, d_a: Tensor, depth: int) -> Vec3:
        """Outgoing radiance toward -d_a of the rays o_a + t d_a (B, N, 3)."""
        b, n_rays, _ = o_a.shape
        t, prim, valid = _brute(scene, o_a, d_a, 1e-4, 1e30)
        d_v = from_array(d_a)
        p = from_array(o_a) + d_v * t
        n_geo, mat_id = _face_normal_mat(scene, prim)
        flip = torch.sign(-n_geo.dot(d_v))
        flip = torch.where(flip == 0, 1.0, flip)
        n = n_geo * flip
        wo = -d_v
        params = bsdf_mod.gather_params(scene.materials, mat_id)
        params["eta_rel"] = torch.where(flip > 0, params["ior"],
                                        1.0 / torch.clamp(params["ior"], min=1e-3))
        # Flat shading: the shading normal is the faced geometric normal
        # (the path tracer's branch without vertex normals).
        ns = n

        out = bsdf_mod._colv(params, "emission")
        out = out + _direct_delta(scene, p, ns, wo, params, n)

        if depth + 1 < max_bounces:
            # L_ind = int f(wo, wi) L_in(wi) cos dwi
            #      ~= sum_k w_k f(wo, wi_k) L_in(wi_k) mu_k
            t_b, bt_b = _onb(ns)
            sin_t = torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0))
            lx, ly = sin_t * torch.cos(phi), sin_t * torch.sin(phi)  # (K,)

            def comp(nc, tc, bc):  # (B, N) -> (B, N * K), node k of ray i at i * K + k
                return (tc[..., None] * lx + bc[..., None] * ly
                        + nc[..., None] * mu).reshape(b, n_rays * n_dirs)

            d_next = torch.stack([comp(ns.x, t_b.x, bt_b.x), comp(ns.y, t_b.y, bt_b.y),
                                  comp(ns.z, t_b.z, bt_b.z)], dim=-1)
            side = torch.where(n.dot(d_v) <= 0, 1.0, -1.0)
            o_next = (p + n * (side * _EPS)).to_array()
            l_in = level(o_next.repeat_interleave(n_dirs, dim=1), d_next, depth + 1)

            params_k = {k: _repeat(v, n_dirs) for k, v in params.items()}
            f_k = bsdf_mod.evaluate_v(params_k, _repeat(ns, n_dirs), _repeat(wo, n_dirs),
                                      from_array(d_next))
            integrand = f_k * l_in
            w_cos = w_q * mu  # (K,): weight * cos(theta)

            def reduce_c(c):
                return (c.reshape(b, n_rays, n_dirs) * w_cos).sum(dim=-1)

            out = out + Vec3(reduce_c(integrand.x), reduce_c(integrand.y),
                             reduce_c(integrand.z))

        # Escaped rays see the constant background in place of surface terms.
        miss = ~valid
        return Vec3(torch.where(miss, bg.x, out.x), torch.where(miss, bg.y, out.y),
                    torch.where(miss, bg.z, out.z))

    return level(o, d, 0).to_array()
