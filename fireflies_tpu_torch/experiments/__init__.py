"""Counterparts of the reference's `experiments/`: prototypes that are not
wired into the renderer, each reached through its own entry point."""
