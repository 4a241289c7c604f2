"""Parametric shape models (port of fireflies_tpu/entity/shape_model.py).

`ShapeModel` is a linear blend-shape mesh, ``verts = template + params @
basis``, whose parameters drift each step by `drift` and reflect at
+-param_limit (the reference's FLAME walk, as a stateless triangle wave of
the step).  `lbs` is SMPL/FLAME linear blend skinning, and
`FlameShapeModel` reads FLAME-format weights from an `.npz`.  Vertices are
differentiable in the parameters and the pose through autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from fireflies_tpu_torch.entity.mesh import Mesh

Tensor = torch.Tensor


class ShapeModel(Mesh):
    """Linear blend-shape model: verts(params) = template +
    einsum('k,kvc->vc', params, basis), basis (K, V, 3)."""

    def __init__(self, name: str, template, basis, faces=None, param_limit: float = 2.0,
                 drift: float = 0.05, n_active: int | None = None):
        template = np.asarray(template, np.float32)
        super().__init__(name, template, faces)
        self._basis = np.asarray(basis, np.float32)
        assert self._basis.shape[1:] == template.shape, (
            f"basis {self._basis.shape} incompatible with template {template.shape}"
        )
        self._param_limit = float(param_limit)
        self._drift = float(drift)
        self._n_active = n_active
        self._randomizable = True
        self._animated = True  # its vertices are drawn every variant

    def n_params(self) -> int:
        return self._basis.shape[0]

    def _blend(self, params: Tensor) -> Tensor:
        params = torch.as_tensor(params, dtype=torch.float32)
        return (torch.as_tensor(self._vertices, device=params.device)
                + torch.einsum("k,kvc->vc", params,
                               torch.as_tensor(self._basis, device=params.device)))

    def get_vertex_data(self, params: Tensor) -> Tensor:
        """The blend-shaped vertices (V, 3) of `params` (K,)."""
        return self._blend(params)

    # The reference's name.
    getVertexData = get_vertex_data

    def sample_params(self, gen, step, train: bool, device, start: Tensor | None = None) -> Tensor:
        """The drift walk, stateless: train mode starts at p0 ~ U(-limit,
        limit) (K,) from `gen` (or `start`, to inject a draw) and moves by
        `drift` a step, reflecting at both limits (a triangle wave of the
        step); eval mode sweeps the first parameter from -limit by `drift`
        a step.  Parameters from `n_active` on are zero."""
        k = self.n_params()
        limit = self._param_limit
        if train:
            if start is None:
                u = torch.rand((k,), generator=gen, device=device)
                start = u * (2.0 * limit) - limit
            x = (torch.as_tensor(start, dtype=torch.float32, device=device)
                 + torch.tensor(float(step), device=device) * self._drift)
            y = torch.remainder(x + limit, 4.0 * limit)
            p = limit - (y - 2.0 * limit).abs()
        else:
            n_steps = max(int(2 * limit / max(self._drift, 1e-6)), 1)
            p0 = -limit + torch.tensor(float(int(step) % n_steps), dtype=torch.float32,
                                       device=device) * self._drift
            p = torch.cat([p0[None], torch.zeros((k - 1,), device=device)])
        if self._n_active is not None and self._n_active < k:
            p = p * (torch.arange(k, device=device) < self._n_active)
        return p

    def sample_local_vertices(self, gen, step, train: bool, device) -> Tensor:
        return self.get_vertex_data(self.sample_params(gen, step, train, device))


def _rodrigues(rvec: Tensor) -> Tensor:
    """Axis-angle vectors (J, 3) -> rotation matrices (J, 3, 3)."""
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    k = rvec / torch.clamp(theta, min=1e-8)
    kx, ky, kz = k[:, 0], k[:, 1], k[:, 2]
    zeros = torch.zeros_like(kx)
    big_k = torch.stack([torch.stack([zeros, -kz, ky], -1), torch.stack([kz, zeros, -kx], -1),
                         torch.stack([-ky, kx, zeros], -1)], dim=-2)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(big_k.shape)
    # theta -> 0: both terms vanish with it, so the formula is safe there.
    return eye + s * big_k + (1.0 - c) * (big_k @ big_k)


def lbs(v_shaped: Tensor, pose: Tensor, j_regressor: Tensor, parents, skin_weights: Tensor,
        posedirs: Tensor | None = None) -> Tensor:
    """Linear blend skinning (the SMPL/FLAME formulation).

    v_shaped (V, 3) blend-shaped rest vertices; pose (J, 3) axis-angle per
    joint (joint 0 the global rotation); j_regressor (J, V) with rest joints
    = j_regressor @ v_shaped; parents (J,) the kinematic chain, parents[0]
    = -1; skin_weights (V, J); posedirs (P, V, 3), P = 9 (J - 1), the
    row-major flattened R[1:] - I (flame_pytorch's convention).  Returns the
    posed vertices (V, 3).
    """
    n_joints = j_regressor.shape[0]
    rot = _rodrigues(pose.reshape(n_joints, 3))
    joints = j_regressor @ v_shaped
    if posedirs is not None and n_joints > 1:
        pose_feature = (rot[1:] - torch.eye(3, dtype=rot.dtype, device=rot.device)).reshape(-1)
        v_shaped = v_shaped + torch.einsum("p,pvc->vc", pose_feature, posedirs)

    # Forward kinematics, the chain unrolled (J is small).
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=v_shaped.dtype, device=v_shaped.device)
    transforms: list = [None] * n_joints
    for j in range(n_joints):
        parent = int(parents[j])
        offset = joints[j] - joints[parent] if parent >= 0 else joints[j]
        local = torch.cat([torch.cat([rot[j], offset[:, None]], 1), bottom], 0)
        transforms[j] = local if parent < 0 else transforms[parent] @ local
    g = torch.stack(transforms)

    # Remove the rest-pose joint locations (SMPL's A = G - pack(G R j_rest)).
    corr = torch.einsum("jab,jb->ja", g[:, :3, :3], joints)
    a = torch.cat([torch.cat([g[:, :3, :3], (g[:, :3, 3] - corr)[..., None]], -1), g[:, 3:]], 1)

    # Skin: v' = sum_j w_vj (A_j [v; 1]).
    t_v = torch.einsum("vj,jab->vab", skin_weights, a)
    v_h = torch.cat([v_shaped, torch.ones_like(v_shaped[:, :1])], -1)
    return torch.einsum("vab,vb->va", t_v, v_h)[:, :3]


class FlameShapeModel(ShapeModel):
    """FLAME morphable head as a randomizable entity: an `.npz` with
    `template` (V, 3), `shapedirs` (V, 3, K) and optionally `faces`; pose
    articulation when it also carries the LBS tables: `posedirs` (P, V, 3)
    or (V, 3, P), `J_regressor` (J, V), `weights` (V, J) and `parents` (J,)
    (or `kintree_table` (2, J)).  Shape parameters beyond the first 20 are
    zero, as in the reference."""

    def __init__(self, name: str, weights_path: str, n_shape: int = 100, n_expr: int = 50):
        data = np.load(weights_path, allow_pickle=True)
        template = np.asarray(data["template"], np.float32)
        shapedirs = np.asarray(data["shapedirs"], np.float32)
        k = min(shapedirs.shape[-1], n_shape + n_expr)
        basis = np.moveaxis(shapedirs[..., :k], -1, 0)
        faces = data["faces"] if "faces" in data else None
        super().__init__(name, template, basis, faces, n_active=20)
        self._n_shape = n_shape
        self._n_expr = n_expr

        self._j_regressor = None
        self._skin_weights = None
        self._posedirs = None
        self._parents = None
        if "J_regressor" in data and "weights" in data:
            self._j_regressor = np.asarray(data["J_regressor"], np.float32)
            self._skin_weights = np.asarray(data["weights"], np.float32)
            if "parents" in data:
                self._parents = np.asarray(data["parents"], np.int64)
            elif "kintree_table" in data:
                self._parents = np.asarray(data["kintree_table"], np.int64)[0]
                self._parents[0] = -1
            else:
                raise ValueError(f"{weights_path}: LBS tables need `parents` or `kintree_table`")
            if "posedirs" in data:
                pd = np.asarray(data["posedirs"], np.float32)
                if pd.ndim == 3 and pd.shape[0] == template.shape[0]:
                    pd = np.moveaxis(pd, -1, 0)  # (V, 3, P) -> (P, V, 3)
                self._posedirs = pd

    @property
    def n_joints(self) -> int:
        return 0 if self._j_regressor is None else self._j_regressor.shape[0]

    def has_pose(self) -> bool:
        return self._j_regressor is not None

    def get_vertex_data(self, params: Tensor, pose: Tensor | None = None) -> Tensor:
        """Blend shapes, then (with the LBS tables and a `pose` (J, 3)) pose
        blend shapes, joint regression and skinning."""
        v_shaped = self._blend(params)
        if pose is None or self._j_regressor is None:
            return v_shaped
        dev = v_shaped.device
        return lbs(v_shaped, pose, torch.as_tensor(self._j_regressor, device=dev), self._parents,
                   torch.as_tensor(self._skin_weights, device=dev),
                   None if self._posedirs is None else torch.as_tensor(self._posedirs, device=dev))

    getVertexData = get_vertex_data
