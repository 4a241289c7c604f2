"""Differentiable bilinear texture sampling (port of the projector part of
fireflies_tpu/render/texture.py).

uv in [0, 1]^2 with u right and v up, clamped at the borders.  A texture is
(H, W, C), shared by every lookup, or (B, H, W, C), one a variant, looked up
at uv of shape (B, ..., 2).  `pack_neighborhood_table` lays each texel's
2x2 neighbourhood out in one row, so a lookup reads one row in place of four
texels; `bilinear_sample_packed` equals `bilinear_sample`.  A lookup is an
index_select, whose backward is an index_add_ (atomic adds on the card, so
the texture gradient's summation order varies from run to run there).  The
texture-stack and envmap forms are not ported yet.
"""

from __future__ import annotations

import torch

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
