"""2D graphics (port of the part of fireflies_tpu/graphics that the
projector texture route uses)."""
