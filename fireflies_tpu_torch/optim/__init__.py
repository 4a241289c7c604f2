"""Inverse-rendering objectives."""

from fireflies_tpu_torch.optim.inverse import hybrid_pose_loss, image_l2

__all__ = ["hybrid_pose_loss", "image_l2"]
