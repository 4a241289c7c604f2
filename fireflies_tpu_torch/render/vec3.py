"""Component-wise 3-vectors (port of fireflies_tpu/render/vec3.py).

`Vec3` holds three broadcast-compatible tensors (typically (B, N) per-ray
components, or (B, 1) per-variant constants), so the path tracer ports line
for line from the reference.  Convert at kernel/API boundaries with
`from_array` / `to_array`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class Vec3(NamedTuple):
    x: Tensor
    y: Tensor
    z: Tensor

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o: "Vec3") -> Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self) -> Tensor:
        return self.dot(self)

    def norm(self) -> Tensor:
        return torch.sqrt(self.norm2())

    def normalized(self, eps: float = 1e-20) -> "Vec3":
        # Primal as the reference: v * rsqrt(max(|v|^2, eps^2)).  The
        # reference's VJP scales like |v|^-3 and overflows to inf for tiny
        # (but nonzero) vectors, turning a zero cotangent into NaN.  The
        # double where keeps the primal and routes tiny vectors through a
        # detached scale, so their gradient stays finite.
        n2 = self.norm2()
        ok = n2 > 1e-24
        inv = torch.where(
            ok,
            torch.rsqrt(torch.where(ok, n2, 1.0)),
            torch.rsqrt(torch.clamp(n2.detach(), min=eps * eps)),
        )
        return self * inv

    def max_component(self) -> Tensor:
        return torch.maximum(torch.maximum(self.x, self.y), self.z)

    def sum(self) -> Tensor:
        return self.x + self.y + self.z

    def to_array(self) -> Tensor:
        """(..., 3) tensor — use only at kernel/API boundaries."""
        x, y, z = torch.broadcast_tensors(self.x, self.y, self.z)
        return torch.stack([x, y, z], dim=-1)


def from_array(a: Tensor) -> Vec3:
    """(..., 3) tensor -> Vec3 of (...) components."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def splat(v: Tensor) -> Vec3:
    """Per-variant (B, 3) (or shared (3,)) constant -> Vec3 whose components
    broadcast against (B, N) per-ray tensors."""
    return Vec3(v[..., 0, None], v[..., 1, None], v[..., 2, None])


def where(mask: Tensor, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )
