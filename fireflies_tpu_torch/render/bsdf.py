"""Principled BSDF: diffuse + GGX specular/metallic lobes (port of
fireflies_tpu/render/bsdf.py).

Implemented: Burley diffuse and isotropic GGX specular with the Schlick
Fresnel metallic/specular/spec_tint mix.  The optional lobes (glass and
thin transmission, clearcoat, sheen, anisotropy, flatness) are not ported:
a material table whose lobe flags turn any of them on raises
NotImplementedError.

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


def _check_lobes(params: dict) -> None:
    flags = params.get("_flags")
    lobes = ALL_LOBES if flags is None else flags
    if lobes:
        raise NotImplementedError(
            f"BSDF lobes {sorted(lobes)} are not ported; only diffuse + GGX specular")


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


def _schlick(u: Tensor) -> Tensor:
    return torch.clamp(1.0 - u, 0.0, 1.0) ** 5


def _luminance(c: Vec3) -> Tensor:
    return 0.2126 * c.x + 0.7152 * c.y + 0.0722 * c.z


def _d_ggx_stable(n: Vec3, h: Vec3, cos_h: Tensor, alpha: Tensor) -> Tensor:
    """Isotropic GGX NDF written as 1 / (pi a^2 (sin^2/a^2 + cos^2)^2) with
    sin^2 = |n x h|^2: no cancellation at the needle peak."""
    sin2 = n.cross(h).norm2()
    a2 = torch.clamp(alpha * alpha, min=1e-8)
    q = sin2 / a2 + cos_h * cos_h
    return 1.0 / torch.clamp(_PI * a2 * q * q, min=_EPS)


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


def _to_world(n: Vec3, t: Vec3, bt: Vec3, lx: Tensor, ly: Tensor, lz: Tensor) -> Vec3:
    return t * lx + bt * ly + n * lz


def evaluate_v(params: dict, n: Vec3, wo: Vec3, wi: Vec3, tangent: Vec3 | None = None) -> Vec3:
    """BSDF value f(wo, wi) as a Vec3 (reflection side only; zero below)."""
    del tangent  # orients the anisotropic lobe only
    _check_lobes(params)
    cos_o_s = n.dot(wo)
    cos_i_s = n.dot(wi)
    reflect_side = (cos_o_s > _EPS) & (cos_i_s > _EPS)
    cos_o = torch.clamp(cos_o_s.abs(), min=_EPS)
    cos_i = torch.clamp(cos_i_s.abs(), min=_EPS)

    h = (wo + wi).normalized()
    cos_h = torch.clamp(n.dot(h), min=0.0)
    cos_d = torch.clamp(wi.dot(h), min=0.0)

    base = _colv(params, "base_color")
    rough = torch.clamp(params["roughness"], 0.01, 1.0)
    metallic = params["metallic"]

    fd90 = 0.5 + 2.0 * rough * cos_d * cos_d
    f_in = 1.0 + (fd90 - 1.0) * _schlick(cos_i)
    f_out = 1.0 + (fd90 - 1.0) * _schlick(cos_o)
    f_diffuse = base * (f_in * f_out * (1.0 - metallic) / _PI)

    lum = torch.clamp(_luminance(base), min=_EPS)
    tint = base * (1.0 / lum)
    spec_color = tint * params["spec_tint"] + (1.0 - params["spec_tint"])
    f0 = spec_color * (0.08 * params["specular"] * (1.0 - metallic)) + base * metallic
    fresnel = f0 + (1.0 - f0) * _schlick(cos_d)
    alpha_s = rough * rough
    d_spec = _d_ggx_stable(n, h, cos_h, alpha_s)
    g_spec = _g_smith_ggx(cos_i, alpha_s) * _g_smith_ggx(cos_o, alpha_s)
    f_specular = fresnel * (d_spec * g_spec / (4.0 * cos_i * cos_o))

    zero = torch.zeros_like(cos_o)
    return v3m.where(reflect_side, f_diffuse + f_specular, Vec3(zero, zero, zero))


def _lobe_probs(params) -> tuple[Tensor, Tensor]:
    """(p_diffuse, p_specular) lobe-selection probabilities."""
    w_d = 1.0 - params["metallic"]
    p_d = torch.clamp(w_d / (w_d + 1.0), 0.05, 0.9)
    return p_d, 1.0 - p_d


def sample_v(params: dict, n: Vec3, wo: Vec3, gens=None, tangent: Vec3 | None = None,
             uniforms: tuple[Tensor, ...] | None = None) -> tuple[Vec3, Tensor, Vec3]:
    """Importance-sample wi; returns (wi, pdf, f).

    One lobe choice per point (cosine hemisphere for diffuse, GGX half
    vector for specular) with the full mixture pdf.  `uniforms`:
    (u_sel, u1, u2[, ...]) draws shaped like n's components; otherwise
    they come from `gens`, one torch.Generator per variant (leading axis).
    """
    del tangent
    _check_lobes(params)
    if uniforms is None:
        from fireflies_tpu_torch.render.rays import uniform  # noqa: PLC0415

        u = uniform(gens, (3, n.x.shape[-1]), n.x.device)
        uniforms = (u[:, 0], u[:, 1], u[:, 2])
    u_sel, u1, u2 = uniforms[:3]
    t, bt = _onb(n)

    r = torch.sqrt(u1)
    phi = 2.0 * _PI * u2
    wi_diff = _to_world(n, t, bt, r * torch.cos(phi), r * torch.sin(phi),
                        torch.sqrt(torch.clamp(1.0 - u1, min=0.0)))

    ax = torch.clamp(params["roughness"], 0.01, 1.0) ** 2
    stretch = torch.sqrt(torch.clamp(u1 / torch.clamp(1.0 - u1, min=1e-9), min=0.0))
    hx = stretch * ax * torch.cos(phi)
    hy = stretch * ax * torch.sin(phi)
    hnorm = torch.sqrt(hx * hx + hy * hy + 1.0)
    h = _to_world(n, t, bt, hx / hnorm, hy / hnorm, 1.0 / hnorm)
    wi_spec = h * (2.0 * wo.dot(h)) - wo

    p_d, _ = _lobe_probs(params)
    wi = v3m.where(u_sel < p_d, wi_diff, wi_spec)
    return wi, pdf_v(params, n, wo, wi), evaluate_v(params, n, wo, wi)


def pdf_v(params: dict, n: Vec3, wo: Vec3, wi: Vec3, tangent: Vec3 | None = None) -> Tensor:
    """Mixture pdf of `sample_v`; the specular half-vector density holds on
    either hemisphere."""
    del tangent
    _check_lobes(params)
    cos_i = n.dot(wi)
    h = (wo + wi).normalized()
    cos_h = torch.clamp(n.dot(h), min=0.0)
    cos_d = torch.clamp(wo.dot(h), min=_EPS)
    pdf_diff = torch.clamp(cos_i, min=0.0) / _PI
    alpha_s = torch.clamp(params["roughness"], 0.01, 1.0) ** 2
    pdf_spec = _d_ggx_stable(n, h, cos_h, alpha_s) * cos_h / (4.0 * cos_d)
    p_d, p_s = _lobe_probs(params)
    pdf_hv = p_s * pdf_spec
    pdf_up = p_d * pdf_diff + pdf_hv
    return torch.where(cos_i > _EPS, pdf_up, torch.where(cos_i < -_EPS, pdf_hv, 0.0))
