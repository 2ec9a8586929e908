"""Model registry and YAML ``model:`` section -> module construction (port
of dmcf_tpu/models/__init__.py: same tuple-ification, same SymNet
layer_channels trunk/ASCC split, same bookkeeping keys dropped)."""

from __future__ import annotations

import logging

from .cconv_net import CConv
from .hrnet import HRNet
from .pbf import PBFNet
from .pointnet import PointNet
from .symnet import SymNet

log = logging.getLogger(__name__)

MODELS = {"HRNet": HRNet, "SymNet": SymNet, "CConv": CConv,
          "PointNet": PointNet}

# keys consumed by the pipeline/bookkeeping, not the module
_NON_MODULE_KEYS = {"name", "ckpt_path", "is_resume", "device", "loss"}


def _tupleize(x):
    if isinstance(x, (list, tuple)):
        return tuple(_tupleize(v) for v in x)
    return x


def build_model(cfg: dict, *, device="cuda", generator=None):
    """Instantiate a model from a YAML ``model:`` section dict.

    Weights are drawn from ``generator`` (a ``torch.Generator``; seed 0 when
    None).  ``device`` defaults to "cuda" and raises when CUDA is absent.
    """
    cfg = dict(cfg)
    name = cfg.get("name", "SymNet")
    if name not in MODELS:
        raise KeyError(f"unknown model: {name}")
    cls = MODELS[name]

    kwargs = {}
    for k, v in cfg.items():
        if k in _NON_MODULE_KEYS:
            continue
        if k not in cls.defaults:
            log.warning("model config key '%s' not used by %s", k, name)
            continue
        if isinstance(v, (list, tuple)):
            v = _tupleize(v)
        if isinstance(v, dict):
            v = dict(v)
        kwargs[k] = v

    lc = _tupleize(kwargs.get("layer_channels",
                              cls.defaults["layer_channels"]))
    if name == "SymNet":
        # reference split: trunk = layer_channels[:-1], ASCC stack =
        # layer_channels[-1][-1]
        last = lc[-1][-1]
        kwargs["sym_channels"] = last if isinstance(last, tuple) \
            else (last,)
        lc = lc[:-1]
    kwargs["layer_channels"] = lc
    # the scale-0 width: CConv and PointNet list one width a layer
    first = lc[0] if name in ("CConv", "PointNet") else lc[0][0]
    kwargs.setdefault("channels",
                      first[0] if isinstance(first, tuple) else first)
    return cls(generator=generator, device=device, **kwargs)


__all__ = ["PBFNet", "HRNet", "SymNet", "CConv", "PointNet", "MODELS",
           "build_model"]
