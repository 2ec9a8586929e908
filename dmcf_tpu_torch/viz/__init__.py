"""2D rollout rendering (``draw2d``; run ``python -m dmcf_tpu_torch.viz.draw2d``)."""

from .draw2d import draw_frame, load_groups, render

__all__ = ["draw_frame", "load_groups", "render"]
