"""Differentiable bilinear texture sampling (port of
fireflies_tpu/render/texture.py).

uv in [0, 1]^2 with u right and v up, clamped at the borders.  A texture is
(H, W, C), shared by every lookup, or (B, H, W, C), one a variant, looked up
at uv of shape (B, ..., 2).  A texture stack (one texture a material) is
(M, H, W, C), or (B, M, H, W, C) one a variant, looked up at a per-point
index.  `pack_neighborhood_table` / `_stack` lay each texel's 2x2
neighbourhood out in one row, so a lookup reads one row in place of four
texels; the packed lookups equal the unpacked ones.  `sample_envmap` looks
an equirectangular (H, W, 3) map up by direction.  A lookup is an
index_select, whose backward is an index_add_ (atomic adds on the card, so
the texture gradient's summation order varies from run to run there).
"""

from __future__ import annotations

import math

import torch

from fireflies_tpu_torch.render.vec3 import rsqrt

Tensor = torch.Tensor


def pack_neighborhood_table(texture: Tensor) -> Tensor:
    """(..., H, W, C) texture -> (..., H*W, 4C) bilinear-corner table: row
    y*W + x holds [c(y, x), c(y, x+1), c(y+1, x), c(y+1, x+1)], neighbours
    clamped at the edges as bilinear_sample clamps them."""
    h, w, c = texture.shape[-3:]
    sx = torch.cat([texture[..., :, 1:, :], texture[..., :, -1:, :]], dim=-2)
    sy = torch.cat([texture[..., 1:, :, :], texture[..., -1:, :, :]], dim=-3)
    sxy = torch.cat([sy[..., :, 1:, :], sy[..., :, -1:, :]], dim=-2)
    table = torch.cat([texture, sx, sy, sxy], dim=-1)
    return table.reshape(*texture.shape[:-3], h * w, 4 * c)


def _bilinear_weights(uv: Tensor, h: int, w: int):
    x = uv[..., 0].clamp(0.0, 1.0) * (w - 1)
    y = (1.0 - uv[..., 1].clamp(0.0, 1.0)) * (h - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i = x0.long().clamp(0, w - 1)
    y0i = y0.long().clamp(0, h - 1)
    return x0i, y0i, fx, fy


def _rows(table: Tensor, index: Tensor, batched: bool) -> Tensor:
    """table[index] for a shared (R, K) table, or table[b, index[b]] for a
    per-variant (B, R, K) one; (*index.shape, K)."""
    k = table.shape[-1]
    if batched:
        b, r = table.shape[0], table.shape[1]
        offset = torch.arange(b, device=index.device).reshape(b, *(1,) * (index.dim() - 1)) * r
        index, table = index + offset, table.reshape(b * r, k)
    return table.index_select(0, index.reshape(-1)).reshape(*index.shape, k)


def _blend(c00, c01, c10, c11, fx, fy) -> Tensor:
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def bilinear_sample_packed(table: Tensor, h: int, w: int, uv: Tensor) -> Tensor:
    """Bilinear lookup in a pack_neighborhood_table table ((H*W, 4C), or
    (B, H*W, 4C) with uv (B, ..., 2)) at uv (..., 2); (..., C).  One row read
    a lookup."""
    c = table.shape[-1] // 4
    x0i, y0i, fx, fy = _bilinear_weights(uv, h, w)
    row = _rows(table, y0i * w + x0i, table.dim() == 3)
    return _blend(row[..., :c], row[..., c:2 * c], row[..., 2 * c:3 * c], row[..., 3 * c:],
                  fx, fy)


def bilinear_sample(texture: Tensor, uv: Tensor) -> Tensor:
    """Bilinear lookup in an (H, W, C) texture, or a (B, H, W, C) one with uv
    (B, ..., 2), at uv (..., 2); (..., C).  Differentiable with respect to
    both texture and uv."""
    h, w, c = texture.shape[-3:]
    batched = texture.dim() == 4
    flat = texture.reshape(*texture.shape[:-3], h * w, c)
    x0i, y0i, fx, fy = _bilinear_weights(uv, h, w)
    x1i = (x0i + 1).clamp(0, w - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    corners = [_rows(flat, yi * w + xi, batched)
               for yi, xi in ((y0i, x0i), (y0i, x1i), (y1i, x0i), (y1i, x1i))]
    return _blend(*corners, fx, fy)


def pack_neighborhood_stack(textures: Tensor) -> Tensor:
    """(..., M, H, W, C) stack -> (..., M*H*W, 4C) table for
    bilinear_sample_stack_packed: texture m's rows start at m*H*W."""
    m, h, w, c = textures.shape[-4:]
    return pack_neighborhood_table(textures).reshape(*textures.shape[:-4], m * h * w, 4 * c)


def bilinear_sample_stack_packed(table: Tensor, h: int, w: int, index: Tensor,
                                 uv: Tensor) -> Tensor:
    """Bilinear lookup of texture `index` (...) of a pack_neighborhood_stack
    table ((M*H*W, 4C), or (B, M*H*W, 4C) with index (B, ...)) at uv
    (..., 2); (..., C).  One row read a lookup."""
    c = table.shape[-1] // 4
    x0i, y0i, fx, fy = _bilinear_weights(uv, h, w)
    row = _rows(table, index.long() * (h * w) + y0i * w + x0i, table.dim() == 3)
    return _blend(row[..., :c], row[..., c:2 * c], row[..., 2 * c:3 * c], row[..., 3 * c:],
                  fx, fy)


def bilinear_sample_stack(textures: Tensor, index: Tensor, uv: Tensor) -> Tensor:
    """Bilinear lookup of texture `index` (...) of an (M, H, W, C) stack,
    or a (B, M, H, W, C) one with index (B, ...), at uv (..., 2); (..., C)."""
    if textures.dim() not in (4, 5):
        # An (H, W, C) texture passed as a stack would read H as materials.
        raise ValueError(f"texture stack must be (M, H, W, C) or (B, M, H, W, C); "
                         f"got shape {tuple(textures.shape)}")
    m, h, w, c = textures.shape[-4:]
    batched = textures.dim() == 5
    flat = textures.reshape(*textures.shape[:-4], m * h * w, c)
    base = index.long() * (h * w)
    x0i, y0i, fx, fy = _bilinear_weights(uv, h, w)
    x1i = (x0i + 1).clamp(0, w - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    corners = [_rows(flat, base + yi * w + xi, batched)
               for yi, xi in ((y0i, x0i), (y0i, x1i), (y1i, x0i), (y1i, x1i))]
    return _blend(*corners, fx, fy)


def sample_envmap(texture: Tensor, dx: Tensor, dy: Tensor, dz: Tensor) -> Tensor:
    """Equirectangular lookup of an (H, W, 3) envmap by direction (dx, dy,
    dz) (...), not necessarily unit; (..., 3).  u = atan2(x, -z) / 2pi + 0.5,
    v = acos(y) / pi with v = 0 at +Y (the image's top row); texel (i, j) is
    centred at theta = pi (i + 0.5) / H, u = (j + 0.5) / W, the cells
    lights.envmap_distribution samples.  The blend wraps across the u seam
    and clamps at the poles.  Differentiable with respect to the texture."""
    inv_len = rsqrt(dx * dx + dy * dy + dz * dz + 1e-20)
    x, y, z = dx * inv_len, dy * inv_len, dz * inv_len
    u = torch.atan2(x, -z) * (0.5 / math.pi) + 0.5
    vt = torch.arccos(y.clamp(-1.0, 1.0)) * (1.0 / math.pi)
    h, w = texture.shape[0], texture.shape[1]
    fx = u * w - 0.5
    fy = vt * h - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0)[..., None], (fy - y0)[..., None]
    x0i = torch.remainder(x0.long(), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = y0.long().clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    flat = texture.reshape(h * w, texture.shape[-1])
    corners = [_rows(flat, yi * w + xi, False)
               for yi, xi in ((y0i, x0i), (y0i, x1i), (y1i, x0i), (y1i, x1i))]
    return _blend(*corners, tx, ty)
