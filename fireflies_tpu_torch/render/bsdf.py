"""Principled BSDF (port of fireflies_tpu/render/bsdf.py).

Lobes: Burley diffuse with flatness (the Hanrahan-Krueger subsurface
lerp), sheen, GGX specular with the Schlick Fresnel metallic / specular /
spec_tint mix (anisotropic GGX with the Disney aspect split and Heitz's
Smith G1, oriented by the uv tangent where the mesh has uvs), GTR1
clearcoat, rough-dielectric glass (spec_trans with thin = 0: Walter's
microfacet refraction and dielectric-Fresnel reflection with `ior`, total
internal reflection, entering or exiting by params["eta_rel"]), and the
Disney-thin diffuse transmission (thin = 1).  `Materials.flags` is the
scene-static set of optional lobes ("trans", "clearcoat", "sheen",
"aniso", "flatness") any material can activate: None turns every lobe
on, and a lobe left out is skipped (its weight would be zero).

Component form throughout (render/vec3.py); all functions are elementwise
over per-point parameter rows (`gather_params`).  `wo` points away from the
surface toward the viewer, `wi` toward the light, both unit; `n` is the
shading normal; values are f without the |cos| factor.
"""

from __future__ import annotations

import math

import torch

from fireflies_tpu_torch.render import vec3 as v3m
from fireflies_tpu_torch.render.types import Materials
from fireflies_tpu_torch.render.vec3 import Vec3, from_array

Tensor = torch.Tensor

_EPS = 1e-7
_PI = math.pi

ALL_LOBES = frozenset({"trans", "clearcoat", "sheen", "aniso", "flatness"})

_FIELDS = (
    "base_color roughness metallic specular spec_tint clearcoat clearcoat_gloss sheen "
    "sheen_tint anisotropic spec_trans flatness ior thin emission"
).split()


def _lobes(params: dict) -> frozenset:
    """The active optional lobes: params["_flags"], None (or absent) = all."""
    flags = params.get("_flags")
    return ALL_LOBES if flags is None else flags


def gather_params(materials: Materials, mat_id: Tensor) -> dict:
    """Per-point parameter rows: mat_id (B, N) into (B, M[, 3]) tables ->
    {field: (B, N[, 3])}."""
    out = {}
    idx = mat_id.long()
    for field in _FIELDS:
        table = getattr(materials, field)
        if table.dim() == 3:
            out[field] = torch.gather(table, 1, idx[..., None].expand(*idx.shape, 3))
        else:
            out[field] = torch.gather(table, 1, idx)
    out["_flags"] = materials.flags
    return out


def _colv(params: dict, field: str) -> Vec3:
    """Colour field as Vec3 (cached in the dict under `<field>_v`)."""
    key = field + "_v"
    if key not in params:
        val = params[field]
        params[key] = val if isinstance(val, Vec3) else from_array(val)
    return params[key]


def _eta_rel(params: dict) -> Tensor:
    """Relative IOR n_t / n_i of the glass lobe: params["eta_rel"] where the
    caller tracks sidedness (ior entering, 1 / ior exiting), else ior.  Kept
    1e-3 away from 1, where the refraction half-vector degenerates."""
    eta = params.get("eta_rel", params["ior"])
    return torch.where((eta - 1.0).abs() < 1e-3,
                       torch.where(eta >= 1.0, 1.0 + 1e-3, 1.0 - 1e-3), eta)


def _fresnel_dielectric(cos_i: Tensor, eta: Tensor) -> Tensor:
    """Unpolarized dielectric Fresnel reflectance for cos_i >= 0 on the
    incident side and eta = n_t / n_i; 1 under total internal reflection."""
    cos_i = cos_i.clamp(0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / torch.clamp(eta * eta, min=_EPS)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=_EPS)
    r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=_EPS)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, f.clamp(0.0, 1.0))


def _schlick(u: Tensor) -> Tensor:
    return torch.clamp(1.0 - u, 0.0, 1.0) ** 5


def _luminance(c: Vec3) -> Tensor:
    return 0.2126 * c.x + 0.7152 * c.y + 0.0722 * c.z


def _aniso_alphas(params: dict) -> tuple[Tensor, Tensor]:
    """Disney anisotropic roughness split: aspect = sqrt(1 - 0.9 aniso)."""
    alpha = torch.clamp(params["roughness"], 0.01, 1.0) ** 2
    aspect = torch.sqrt(1.0 - 0.9 * params["anisotropic"].clamp(0.0, 1.0))
    return torch.clamp(alpha / aspect, min=1e-4), torch.clamp(alpha * aspect, min=1e-4)


def _d_ggx(cos_h: Tensor, alpha: Tensor) -> Tensor:
    """Textbook isotropic GGX NDF (the glass lobe's)."""
    a2 = alpha * alpha
    denom = cos_h * cos_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(_PI * denom * denom, min=_EPS)


def _d_ggx_stable(n: Vec3, h: Vec3, cos_h: Tensor, alpha: Tensor) -> Tensor:
    """Isotropic GGX NDF written as 1 / (pi a^2 (sin^2/a^2 + cos^2)^2) with
    sin^2 = |n x h|^2: no cancellation at the needle peak."""
    sin2 = n.cross(h).norm2()
    a2 = torch.clamp(alpha * alpha, min=1e-8)
    q = sin2 / a2 + cos_h * cos_h
    return 1.0 / torch.clamp(_PI * a2 * q * q, min=_EPS)


def _d_ggx_aniso(hx: Tensor, hy: Tensor, hz: Tensor, ax: Tensor, ay: Tensor) -> Tensor:
    """Anisotropic GGX NDF in the local (tangent, bitangent, normal) frame."""
    q = (hx * hx) / (ax * ax) + (hy * hy) / (ay * ay) + hz * hz
    return 1.0 / torch.clamp(_PI * ax * ay * q * q, min=_EPS)


def _g1_smith_aniso(wx: Tensor, wy: Tensor, wz: Tensor, ax: Tensor, ay: Tensor) -> Tensor:
    """Smith G1 with per-axis roughness (Heitz 2014)."""
    wz2 = torch.clamp(wz * wz, min=_EPS)
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + (ax * ax * wx * wx + ay * ay * wy * wy) / wz2))
    return 1.0 / (1.0 + lam)


def _d_gtr1(cos_h: Tensor, alpha: Tensor) -> Tensor:
    a2 = alpha * alpha
    denom = _PI * torch.log(torch.clamp(a2, min=_EPS)) * (1.0 + (a2 - 1.0) * cos_h * cos_h)
    return (a2 - 1.0) / torch.where(denom.abs() < _EPS, _EPS, denom)


def _g_smith_ggx(cos_v: Tensor, alpha: Tensor) -> Tensor:
    a2 = alpha * alpha
    c2 = cos_v * cos_v
    return 2.0 * cos_v / torch.clamp(cos_v + torch.sqrt(a2 + c2 - a2 * c2), min=_EPS)


def _onb(n: Vec3) -> tuple[Vec3, Vec3]:
    """Orthonormal basis around n (Frisvad-style, branchless)."""
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    t = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bt = Vec3(b, sign + n.y * n.y * a, -n.y)
    return t, bt


def _frame(n: Vec3, tangent: Vec3 | None) -> tuple[Vec3, Vec3]:
    """Shading tangent frame: the (uv-derived) tangent orthonormalized
    against n, else (or where it degenerates) the ONB of n."""
    if tangent is None:
        return _onb(n)
    t = tangent - n * tangent.dot(n)
    norm = t.norm()
    t_onb, _ = _onb(n)
    t = v3m.where(norm > 1e-6, t * (1.0 / torch.clamp(norm, min=1e-12)), t_onb)
    return t, n.cross(t)


def _to_world(n: Vec3, t: Vec3, bt: Vec3, lx: Tensor, ly: Tensor, lz: Tensor) -> Vec3:
    return t * lx + bt * ly + n * lz


def _zero(like: Tensor) -> Vec3:
    z = torch.zeros_like(like)
    return Vec3(z, z, z)


def evaluate_v(params: dict, n: Vec3, wo: Vec3, wi: Vec3, tangent: Vec3 | None = None) -> Vec3:
    """BSDF value f(wo, wi) as a Vec3: the reflection lobes where wo and wi
    lie above n, the transmission lobes where wi lies below, 0 elsewhere."""
    cos_o_s = n.dot(wo)
    cos_i_s = n.dot(wi)
    reflect_side = (cos_o_s > _EPS) & (cos_i_s > _EPS)
    trans_side = (cos_o_s > _EPS) & (cos_i_s < -_EPS)
    cos_o = torch.clamp(cos_o_s.abs(), min=_EPS)
    cos_i = torch.clamp(cos_i_s.abs(), min=_EPS)

    h = (wo + wi).normalized()
    cos_h = torch.clamp(n.dot(h), min=0.0)
    cos_d = torch.clamp(wi.dot(h), min=0.0)

    base = _colv(params, "base_color")
    rough = torch.clamp(params["roughness"], 0.01, 1.0)
    metallic = params["metallic"]
    lobes = _lobes(params)
    has_trans = "trans" in lobes

    # Burley diffuse, lerped toward the subsurface approximation by flatness.
    fd90 = 0.5 + 2.0 * rough * cos_d * cos_d
    f_in = 1.0 + (fd90 - 1.0) * _schlick(cos_i)
    f_out = 1.0 + (fd90 - 1.0) * _schlick(cos_o)
    diff_mix = f_in * f_out
    if "flatness" in lobes:
        flatness = params["flatness"]
        fss90 = rough * cos_d * cos_d
        fss_in = 1.0 + (fss90 - 1.0) * _schlick(cos_i)
        fss_out = 1.0 + (fss90 - 1.0) * _schlick(cos_o)
        ss = 1.25 * (fss_in * fss_out * (1.0 / (cos_i + cos_o) - 0.5) + 0.5)
        diff_mix = diff_mix * (1.0 - flatness) + ss * flatness
    diffuse_weight = (1.0 - metallic) * ((1.0 - params["spec_trans"]) if has_trans else 1.0)
    f_diffuse = base * (diff_mix * diffuse_weight / _PI)

    lum = torch.clamp(_luminance(base), min=_EPS)
    tint = base * (1.0 / lum)
    extra = []  # sheen (a Vec3) and clearcoat (grey), added on the reflection side
    if "sheen" in lobes:
        sheen_color = tint * params["sheen_tint"] + (1.0 - params["sheen_tint"])
        extra.append(sheen_color * (params["sheen"] * _schlick(cos_d) * (1.0 - metallic)))

    spec_color = tint * params["spec_tint"] + (1.0 - params["spec_tint"])
    f0 = spec_color * (0.08 * params["specular"] * (1.0 - metallic)) + base * metallic
    fresnel = f0 + (1.0 - f0) * _schlick(cos_d)
    if "aniso" in lobes:
        ax, ay = _aniso_alphas(params)
        t, bt = _frame(n, tangent)
        d_spec = _d_ggx_aniso(h.dot(t), h.dot(bt), cos_h, ax, ay)
        g_spec = (_g1_smith_aniso(wi.dot(t), wi.dot(bt), cos_i, ax, ay)
                  * _g1_smith_aniso(wo.dot(t), wo.dot(bt), cos_o, ax, ay))
    else:
        alpha_s = rough * rough
        d_spec = _d_ggx_stable(n, h, cos_h, alpha_s)
        g_spec = _g_smith_ggx(cos_i, alpha_s) * _g_smith_ggx(cos_o, alpha_s)
    f_specular = fresnel * (d_spec * g_spec / (4.0 * cos_i * cos_o))

    if "clearcoat" in lobes:
        gloss = params["clearcoat_gloss"]
        alpha_cc = 0.1 * (1.0 - gloss) + 0.001 * gloss
        g_alpha = torch.full_like(alpha_cc, 0.25)
        g_cc = _g_smith_ggx(cos_i, g_alpha) * _g_smith_ggx(cos_o, g_alpha)
        f_cc = 0.04 + 0.96 * _schlick(cos_d)
        scalar = 0.25 * params["clearcoat"] * _d_gtr1(cos_h, alpha_cc) * f_cc * g_cc
        extra.append(scalar / (4.0 * cos_i * cos_o))

    if not has_trans:
        f_up = f_diffuse + f_specular
        for e in extra:
            f_up = f_up + e
        return v3m.where(reflect_side, f_up, _zero(cos_o))

    # Glass (rough dielectric): its dielectric-Fresnel reflection takes the
    # plain specular's place for its share, plus the (1 - F) refraction.
    eta = _eta_rel(params)
    thin = params["thin"].clamp(0.0, 1.0)
    glass_w = params["spec_trans"] * (1.0 - metallic) * (1.0 - thin)
    alpha_g = torch.clamp(params["roughness"], 0.01, 1.0) ** 2

    f_dielec = _fresnel_dielectric(cos_d, eta)
    d_g = _d_ggx(cos_h, alpha_g)
    g_g = _g_smith_ggx(cos_i, alpha_g) * _g_smith_ggx(cos_o, alpha_g)
    f_glass_refl = f_dielec * d_g * g_g / (4.0 * cos_i * cos_o)

    # Refraction half-vector normalize(wo + eta wi), flipped above n.
    wh_t = (wo + wi * eta).normalized()
    wh_t = wh_t * torch.sign(wh_t.dot(n) + 1e-20)
    cos_wh = wh_t.dot(n).clamp(0.0, 1.0)
    wo_wh = wo.dot(wh_t)
    wi_wh = wi.dot(wh_t)
    sqrt_denom = wo_wh + eta * wi_wh
    f_t_dielec = _fresnel_dielectric(wo_wh.abs(), eta)
    t_tint = Vec3(*(torch.sqrt(torch.clamp(c, min=0.0)) for c in base))
    # A physical refraction pair straddles its half-vector.
    refr_ok = (wo_wh > _EPS) & (wi_wh < -_EPS)
    glass_trans = torch.where(
        refr_ok,
        (1.0 - f_t_dielec) * _d_ggx(cos_wh, alpha_g) * g_g * wi_wh.abs() * wo_wh.abs()
        / torch.clamp(cos_i * cos_o * sqrt_denom * sqrt_denom, min=_EPS),
        0.0)

    f_up = f_diffuse + f_specular * (1.0 - glass_w) + f_glass_refl * glass_w
    for e in extra:
        f_up = f_up + e
    trans_weight = params["spec_trans"] * (1.0 - metallic)
    f_down = t_tint * (trans_weight * thin / _PI) + (t_tint * glass_trans) * glass_w
    return v3m.where(reflect_side, f_up, v3m.where(trans_side, f_down, _zero(cos_o)))


def _lobe_probs(params: dict) -> tuple[Tensor, Tensor, Tensor]:
    """(p_diffuse, p_specular, p_transmission) lobe-selection probabilities."""
    w_t = (params["spec_trans"] * (1.0 - params["metallic"])).clamp(0.0, 1.0)
    w_d = (1.0 - params["metallic"]) * (1.0 - w_t)
    p_d = torch.clamp(w_d / (w_d + 1.0), 0.05, 0.9)
    p_t = torch.clamp(0.9 * w_t, 0.0, 0.5)
    scale = 1.0 - p_t
    return p_d * scale, (1.0 - p_d) * scale, p_t


def sample_v(params: dict, n: Vec3, wo: Vec3, gens=None, tangent: Vec3 | None = None,
             uniforms: tuple[Tensor, ...] | None = None) -> tuple[Vec3, Tensor, Vec3]:
    """Importance-sample wi; returns (wi, pdf, f).

    One lobe choice per point: cosine hemisphere for diffuse, the GGX half
    vector for specular, and for transmission the lower cosine hemisphere
    (thin) or glass (a GGX half vector, then Fresnel-weighted reflection or
    refraction, total internal reflection reflecting); pdf is the full
    mixture pdf.  `uniforms`: the reference's five draws (u_sel, u1, u2,
    u3, u4), shaped like n's components (u3 and u4 serve the transmission
    lobe only); otherwise they come from `gens`, one torch.Generator per
    variant (three draws a point without the transmission lobe, five with
    it).
    """
    lobes = _lobes(params)
    has_trans = "trans" in lobes
    if uniforms is None:
        from fireflies_tpu_torch.render.rays import uniform  # noqa: PLC0415

        u = uniform(gens, (5 if has_trans else 3, n.x.shape[-1]), n.x.device)
        uniforms = tuple(u[:, k] for k in range(u.shape[1]))
    u_sel, u1, u2 = uniforms[:3]
    t, bt = _frame(n, tangent)

    r = torch.sqrt(u1)
    phi = 2.0 * _PI * u2
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    wi_diff = _to_world(n, t, bt, r * cos_phi, r * sin_phi,
                        torch.sqrt(torch.clamp(1.0 - u1, min=0.0)))

    if "aniso" in lobes:
        ax, ay = _aniso_alphas(params)
    else:
        ax = ay = torch.clamp(params["roughness"], 0.01, 1.0) ** 2
    stretch = torch.sqrt(torch.clamp(u1 / torch.clamp(1.0 - u1, min=1e-9), min=0.0))
    hx = stretch * ax * cos_phi
    hy = stretch * ay * sin_phi
    hnorm = torch.sqrt(hx * hx + hy * hy + 1.0)
    h = _to_world(n, t, bt, hx / hnorm, hy / hnorm, 1.0 / hnorm)
    wi_spec = h * (2.0 * wo.dot(h)) - wo

    p_d, p_s, _ = _lobe_probs(params)
    wi = v3m.where(u_sel < p_d, wi_diff, wi_spec)

    if has_trans:
        u3, u4 = uniforms[3], uniforms[4]
        eta = _eta_rel(params)
        alpha_g = torch.clamp(params["roughness"], 0.01, 1.0) ** 2
        cos_hg = torch.sqrt(((1.0 - u1) / (1.0 + (alpha_g * alpha_g - 1.0) * u1)).clamp(0.0, 1.0))
        sin_hg = torch.sqrt(torch.clamp(1.0 - cos_hg * cos_hg, min=0.0))
        hg = _to_world(n, t, bt, sin_hg * cos_phi, sin_hg * sin_phi, cos_hg)
        wo_hg = wo.dot(hg)
        hh = hg * torch.sign(wo_hg + _EPS)  # the half vector on wo's side
        c = wo_hg.abs()
        f_g = _fresnel_dielectric(c, eta)
        wi_grefl = hh * (2.0 * c) - wo
        sin2_t = torch.clamp(1.0 - c * c, min=0.0) / torch.clamp(eta * eta, min=_EPS)
        cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
        wi_grefr = ((-wo) * (1.0 / eta) + hh * ((c / eta) - cos_t)).normalized()
        wi_glass = v3m.where((u3 < f_g) | (sin2_t >= 1.0), wi_grefl, wi_grefr)
        thin = params["thin"].clamp(0.0, 1.0)
        wi_trans = v3m.where(u4 < thin, -wi_diff, wi_glass)
        wi = v3m.where(u_sel >= (p_d + p_s), wi_trans, wi)

    return (wi, pdf_v(params, n, wo, wi, tangent=tangent),
            evaluate_v(params, n, wo, wi, tangent=tangent))


def pdf_v(params: dict, n: Vec3, wo: Vec3, wi: Vec3, tangent: Vec3 | None = None) -> Tensor:
    """Mixture pdf of `sample_v`.  The half-vector lobes' densities
    (specular and glass reflection and refraction) hold on either
    hemisphere; the diffuse and thin ones on their own."""
    cos_i = n.dot(wi)
    h = (wo + wi).normalized()
    cos_h = torch.clamp(n.dot(h), min=0.0)
    cos_d = torch.clamp(wo.dot(h), min=_EPS)
    lobes = _lobes(params)

    pdf_diff = torch.clamp(cos_i, min=0.0) / _PI
    if "aniso" in lobes:
        ax, ay = _aniso_alphas(params)
        t, bt = _frame(n, tangent)
        pdf_spec = _d_ggx_aniso(h.dot(t), h.dot(bt), cos_h, ax, ay) * cos_h / (4.0 * cos_d)
    else:
        alpha_s = torch.clamp(params["roughness"], 0.01, 1.0) ** 2
        pdf_spec = _d_ggx_stable(n, h, cos_h, alpha_s) * cos_h / (4.0 * cos_d)
    p_d, p_s, p_t = _lobe_probs(params)

    if "trans" not in lobes:
        pdf_hv = p_s * pdf_spec
        pdf_up = p_d * pdf_diff + pdf_hv
        return torch.where(cos_i > _EPS, pdf_up, torch.where(cos_i < -_EPS, pdf_hv, 0.0))

    pdf_thin = torch.clamp(-cos_i, min=0.0) / _PI
    eta = _eta_rel(params)
    thin = params["thin"].clamp(0.0, 1.0)
    alpha_g = torch.clamp(params["roughness"], 0.01, 1.0) ** 2
    pdf_grefl = _d_ggx(cos_h, alpha_g) * cos_h / (4.0 * cos_d) * _fresnel_dielectric(cos_d, eta)
    # Refraction: wh_t = normalize(wo + eta wi), Jacobian
    # eta^2 |wi.wh| / (wo.wh + eta wi.wh)^2; only straddling pairs count.
    wh_t = (wo + wi * eta).normalized()
    wh_t = wh_t * torch.sign(wh_t.dot(n) + 1e-20)
    cos_wh = wh_t.dot(n).clamp(0.0, 1.0)
    wo_wh = wo.dot(wh_t)
    wi_wh = wi.dot(wh_t)
    sqrt_denom = wo_wh + eta * wi_wh
    jac = eta * eta * wi_wh.abs() / torch.clamp(sqrt_denom * sqrt_denom, min=_EPS)
    f_wh = _fresnel_dielectric(wo_wh.abs(), eta)
    refr_ok = (wo_wh > _EPS) & (wi_wh < -_EPS)
    pdf_grefr = torch.where(refr_ok, _d_ggx(cos_wh, alpha_g) * cos_wh * jac * (1.0 - f_wh), 0.0)

    pdf_hv = p_s * pdf_spec + p_t * (1.0 - thin) * (pdf_grefl + pdf_grefr)
    pdf_up = p_d * pdf_diff + pdf_hv
    pdf_down = p_t * thin * pdf_thin + pdf_hv
    return torch.where(cos_i > _EPS, pdf_up, torch.where(cos_i < -_EPS, pdf_down, 0.0))
