"""Port parity for the optional BSDF lobes (glass and thin transmission,
clearcoat, sheen, anisotropy, flatness) against the JAX functions, on
random frames made with numpy and fed to both packages, every lobe on
(`Materials.flags` None).

  * evaluate_v / pdf_v for every case of tests/test_furnace.py's
    LOBE_CASES, and the glass lobe entering, exiting and in total internal
    reflection: 1e-5 relative, 1e-6 absolute.  Where a half vector sits in
    the narrow peak of the textbook GGX or GTR1 NDF (the glass and
    clearcoat lobes divide by 1 - cos^2 (1 - a^2), which turns the last-ulp
    rounding of cos into a relative error up to `_CONDITION` times larger),
    the relative tolerance grows with that gain beyond `_CONDITION`;
  * sample_v with the reference's five injected uniforms: wi to 1e-5, pdf
    and f at the port's direction as above, with the floor of 1e-5 of the
    largest value that tests/test_torch_shading.py gives sampled values;
  * flag narrowing equals all-on, and the bridge's flags equal JAX's.
"""

import jax.numpy as jnp
import numpy as np
import torch
from test_furnace import LOBE_CASES
from test_torch_shading import N, _close, _unit, _v

from fireflies_tpu.render import bsdf as jx_bsdf
from fireflies_tpu_torch.render import bsdf as tc_bsdf

torch.set_num_threads(1)

_CONDITION = 10.0
DEFAULTS = dict(base_color=(0.9, 0.6, 0.4), roughness=0.5, metallic=0.0, specular=0.5,
                spec_tint=0.0, clearcoat=0.0, clearcoat_gloss=1.0, sheen=0.0, sheen_tint=0.5,
                anisotropic=0.0, spec_trans=0.0, flatness=0.0, ior=1.5, thin=0.0,
                emission=(0.0, 0.0, 0.0))
GLASS = dict(roughness=0.4, spec_trans=1.0, ior=1.5)


def _params(over, lib, flags=None, eta_rel=None):
    out = {}
    for k, v in dict(DEFAULTS, **over).items():
        a = np.broadcast_to(np.asarray(v, np.float32), (N, 3) if np.ndim(v) else (N,)).copy()
        out[k] = jnp.asarray(a) if lib == "jax" else torch.as_tensor(a)
    if eta_rel is not None:
        out["eta_rel"] = (jnp.full((N,), eta_rel, jnp.float32) if lib == "jax"
                          else torch.full((N,), eta_rel, dtype=torch.float32))
    if flags is not None:
        out["_flags"] = flags
    return out


def _frames(seed, grazing=False):
    """n, wo on n's side (cos in [0.05, 0.5] with `grazing`), wi on either
    side, a tangent, and the five uniforms."""
    rng = np.random.default_rng(seed)
    n = _unit(rng, N)
    wo = _unit(rng, N)
    wo = np.where(np.sum(wo * n, -1, keepdims=True) < 0, -wo, wo)
    if grazing:
        t = _unit(rng, N)
        t -= n * np.sum(t * n, -1, keepdims=True)
        t /= np.linalg.norm(t, axis=-1, keepdims=True)
        c = rng.uniform(0.05, 0.5, size=(N, 1)).astype(np.float32)
        wo = (c * n + np.sqrt(1 - c * c) * t).astype(np.float32)
    return n, wo, _unit(rng, N), _unit(rng, N), rng.uniform(size=(5, N)).astype(np.float32)


def _peak_condition(n, wo, wi, over, eta):
    """Per point, the largest gain from the inputs' last-ulp rounding to the
    relative error of a lobe's value: the textbook NDFs of the glass and
    clearcoat lobes, 4 c^2 (1 - a^2) / (1 - c^2 (1 - a^2)) at the
    reflection and refraction half vectors; the glass lobe's Fresnel term
    near the critical angle, s / (1 - s) with s = (1 - c^2) / eta^2; and
    the half-vector densities' 1 / (4 wo.h), 1 / (wo.h)."""
    p = dict(DEFAULTS, **over)
    glass = p["spec_trans"] > 0 and p["thin"] < 1
    alphas = [np.clip(p["roughness"], 0.01, 1.0) ** 2] if glass else []
    if p["clearcoat"]:
        g = p["clearcoat_gloss"]
        alphas.append(0.1 * (1 - g) + 0.001 * g)
    worst = np.zeros(N)
    for i, h in enumerate([wo + wi, wo + eta * wi] if glass else [wo + wi]):
        h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-20)
        c = np.abs(np.sum(n * h, -1))
        for a in alphas:
            k = 1.0 - a * a
            worst = np.maximum(worst, 4 * c * c * k / np.maximum(1 - c * c * k, 1e-12))
        c_d = np.abs(np.sum(wo * h, -1))
        if i == 0:
            worst = np.maximum(worst, 1.0 / np.maximum(c_d, 1e-7))
        if glass:
            sin2 = (1 - c_d * c_d) / (eta * eta)
            worst = np.maximum(worst, np.where(sin2 < 1, sin2 / np.maximum(1 - sin2, 1e-12), 0))
    return worst


def _close_conditioned(ours, theirs, condition, peak_floor=False):
    """1e-5 relative, 1e-6 absolute; 1e-5 relative times condition /
    _CONDITION where the condition exceeds _CONDITION; with `peak_floor`
    (a sampled direction, on the GGX needle) at least 1e-5 of the largest
    value, as tests/test_torch_shading.py holds sampled values."""
    ours = (ours.to_array() if hasattr(ours, "to_array") else ours).detach().numpy()
    theirs = np.asarray(theirs.to_array() if hasattr(theirs, "to_array") else theirs)
    gain = np.maximum(condition / _CONDITION, 1.0)
    if ours.ndim == 2:
        gain = gain[:, None]
    tol = 1e-6 + 1e-5 * gain * np.abs(theirs)
    if peak_floor:
        tol = np.maximum(tol, 1e-5 * np.abs(theirs).max())
    bad = np.abs(ours - theirs) > tol
    assert not bad.any(), (int(bad.sum()), np.abs(ours - theirs)[bad][:4], theirs[bad][:4],
                           np.broadcast_to(gain, bad.shape)[bad][:4])


def _both(seed, over, grazing=False, eta_rel=None):
    n, wo, wi, tan, u = _frames(seed, grazing)
    jx = [_v(x, "jax") for x in (n, wo, wi, tan)] + [_params(over, "jax", eta_rel=eta_rel)]
    tc = [_v(x, "torch") for x in (n, wo, wi, tan)] + [_params(over, "torch", eta_rel=eta_rel)]
    eta = over.get("ior", 1.5) if eta_rel is None else eta_rel
    return (n, wo, wi, u), jx, tc, _peak_condition(n, wo, wi, over, eta)


CASES = dict({name: (over, None, False) for name, (over, _, _) in LOBE_CASES.items()},
             glass_entering=(GLASS, 1.5, False), glass_exiting=(GLASS, 1 / 1.5, False),
             glass_tir=(GLASS, 1 / 1.5, True))


def test_evaluate_and_pdf_match_every_lobe():
    for i, (name, (over, eta_rel, grazing)) in enumerate(sorted(CASES.items())):
        _, (nj, woj, wij, tj, pj), (nt, wot, wit, tt, pt), cond = _both(i, over, grazing, eta_rel)
        _close_conditioned(tc_bsdf.evaluate_v(pt, nt, wot, wit, tangent=tt),
                           jx_bsdf.evaluate_v(pj, nj, woj, wij, tangent=tj), cond)
        _close_conditioned(tc_bsdf.pdf_v(pt, nt, wot, wit, tangent=tt),
                           jx_bsdf.pdf_v(pj, nj, woj, wij, tangent=tj), cond)
        assert (cond <= _CONDITION).mean() > 0.5, name


def test_sample_matches_with_injected_uniforms():
    for i, (name, (over, eta_rel, grazing)) in enumerate(sorted(CASES.items())):
        (n, wo, _, u), (nj, woj, _, tj, pj), (nt, wot, _, tt, pt), _ = _both(
            100 + i, over, grazing, eta_rel)
        wi_t, pdf_t, f_t = tc_bsdf.sample_v(pt, nt, wot, tangent=tt,
                                            uniforms=tuple(torch.as_tensor(x) for x in u))
        wi_j, _, _ = jx_bsdf.sample_v(pj, nj, woj, None, tangent=tj,
                                      uniforms=tuple(jnp.asarray(x) for x in u))
        _close(wi_t, wi_j)
        wi_np = wi_t.to_array().numpy()
        wi_tj = _v(wi_np, "jax")
        cond = _peak_condition(n, wo, wi_np, over, over.get("ior", 1.5) if eta_rel is None
                               else eta_rel)
        _close_conditioned(pdf_t, jx_bsdf.pdf_v(pj, nj, woj, wi_tj, tangent=tj), cond, True)
        _close_conditioned(f_t, jx_bsdf.evaluate_v(pj, nj, woj, wi_tj, tangent=tj), cond, True)
        below = (wi_t.to_array().numpy() * n).sum(-1) < 0
        if over.get("spec_trans") and name != "glass_tir":
            assert below.any(), name  # the transmission lobe was sampled


def test_narrowed_flags_equal_all_on():
    """A lobe's flag alone reproduces the all-on result for materials that
    use only that lobe, and no flag for materials that use none (the
    pattern of tests/test_bsdf_specialize.py, at its 2e-5 relative; the
    all-on table takes the anisotropic GGX form at anisotropic 0, which
    rounds apart from the isotropic one on the specular needle, so the
    absolute floor is 2e-5 of the largest value)."""
    n, wo, wi, tan, _ = _frames(200)
    nt, wot, wit, tt = (_v(x, "torch") for x in (n, wo, wi, tan))
    cases = [(frozenset({"flatness"}), dict(flatness=0.7)), (frozenset({"sheen"}), dict(sheen=0.8)),
             (frozenset({"clearcoat"}), dict(clearcoat=0.9)),
             (frozenset({"aniso"}), dict(anisotropic=0.6)),
             (frozenset({"trans"}), dict(spec_trans=0.5, thin=0.3)), (frozenset(), {})]
    for flags, over in cases:
        p_all, p_one = _params(over, "torch"), _params(over, "torch", flags=flags)
        for fn in (tc_bsdf.evaluate_v, tc_bsdf.pdf_v):
            one, every = (fn(p, nt, wot, wit, tangent=tt) for p in (p_one, p_all))
            one, every = (x.to_array().numpy() if hasattr(x, "to_array") else x.numpy()
                          for x in (one, every))
            np.testing.assert_allclose(one, every, rtol=2e-5, atol=2e-5 * np.abs(every).max())


def _plane_scene(ff, procedural, mat):
    scene = ff.Scene()
    v, f = procedural.make_plane()[:2]
    scene.add_mesh(ff.Mesh("mesh-plane", v - v.mean(0), f), material=mat.name())
    scene.add_material(mat)
    cam = ff.Transformable("PerspectiveCamera")
    w = np.eye(4, dtype=np.float32)
    w[2, 3] = 4.0
    cam.set_world(w)
    scene.set_camera(cam)
    return scene


def test_bridge_lobe_flags_match():
    """The scene-static flags from base values, samplers and nested keys,
    and those of the materials shape (the farm scene's randomized
    clearcoat and sheen), equal the JAX bridge's (the pattern of
    tests/test_bsdf_specialize.py)."""
    import fireflies_tpu as jff
    import fireflies_tpu_torch as tff
    from fireflies_tpu.assets import procedural as jproc
    from fireflies_tpu.render.bridge import SceneBridge as JxBridge
    from fireflies_tpu_torch import main_path
    from fireflies_tpu_torch.assets import procedural as tproc
    from fireflies_tpu_torch.render.bridge import SceneBridge as TcBridge

    def variants(ff):
        mats = [ff.Material("mat-a"), ff.Material("mat-b", spec_trans=0.4),
                ff.Material("mat-c"), ff.Material("mat-d"), ff.Material("mat-e", flatness=0.2)]
        mats[2].add_float_key("clearcoat", 0.0, 1.0)
        mats[3].add_float_key("brdf_0.anisotropic.value", 0.0, 0.5)
        mats[4].add_float_key("brdf_0.sheen.value", 0.0, 0.5)
        return mats

    seen = set()
    for mj, mt in zip(variants(jff), variants(tff)):
        flags = TcBridge(_plane_scene(tff, tproc, mt))._lobe_flags
        assert flags == JxBridge(_plane_scene(jff, jproc, mj))._lobe_flags
        seen.add(flags)
    assert len(seen) == 5

    from fireflies_tpu import sampling as jsampling
    from fireflies_tpu.assets import scenes as jscenes

    scene, kw = jscenes.vocalfold(resolution=8, n_anim_frames=2)
    for k in ("clearcoat", "roughness", "sheen"):
        scene.material("mat-Mucosa").add_float_key(k, 0.0, 1.0)
    scene.light("emit-Spot").add_vec3_sampler(
        "intensity.value", jsampling.UniformScalarToVec3Sampler.create(5.0, 25.0))
    bridge_t = main_path.build_shape("materials", "cpu", 128)[0]
    assert bridge_t._lobe_flags == JxBridge(scene, **kw)._lobe_flags == {"clearcoat", "sheen"}
