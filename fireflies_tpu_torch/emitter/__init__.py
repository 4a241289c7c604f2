"""Emitters (port of fireflies_tpu/emitter).

A Light is a Transformable that also carries its static emitter kind and
default parameters, so the bridge can build the light table.
"""

from __future__ import annotations

from fireflies_tpu_torch.entity.transformable import Transformable


class Light(Transformable):
    """A randomizable emitter; kind: "point" | "spot" | "projector"."""

    def __init__(self, name: str, kind: str = "point", **defaults):
        super().__init__(name)
        self._kind = kind
        self._defaults = dict(defaults)

    def kind(self) -> str:
        return self._kind

    def defaults(self) -> dict:
        return self._defaults


__all__ = ["Light"]
