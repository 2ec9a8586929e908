"""2D rollout rendering (``draw2d``; run ``python -m dmcf_tpu_torch.viz.draw2d``)."""
