"""Config system: YAML configs with three fixed sections (dataset/model/pipeline)
plus arbitrary dotted CLI overrides (the port's own copy of
dmcf_tpu/utils/config.py: same YAML shape, same ``--a.b.c value`` override
idiom with string->int/float/bool coercion, same merged dicts).
"""

from __future__ import annotations

import yaml


class ConfigDict(dict):
    """dict with attribute access; missing keys read as empty ConfigDict (falsy)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        if args:
            d = args[0] or {}
            for k, v in dict(d).items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, ConfigDict._wrap(value))

    __setattr__ = __setitem__

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            # Missing keys behave like addict: empty, falsy mapping.
            return ConfigDict()

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def get(self, key, default=None):
        return super().get(key, default)

    def to_dict(self):
        out = {}
        for k, v in self.items():
            if isinstance(v, ConfigDict):
                out[k] = v.to_dict()
            elif isinstance(v, (list, tuple)):
                out[k] = [x.to_dict() if isinstance(x, ConfigDict) else x for x in v]
            else:
                out[k] = v
        return out

    def copy(self):
        return ConfigDict(self.to_dict())


def _coerce(value):
    """String -> bool/int/float/None coercion for CLI override values
    (mirrors reference _merge_a_into_b coercion, o3d/utils/config.py:188-216)."""
    if not isinstance(value, str):
        return value
    low = value.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("none", "null", ""):
        return None
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    if value.startswith(("[", "{")):
        try:
            return yaml.safe_load(value)
        except Exception:
            pass
    return value


def _merge_into(target: ConfigDict, path: list, value):
    cur = target
    for p in path[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, ConfigDict):
            nxt = ConfigDict()
            cur[p] = nxt
        cur = nxt
    cur[path[-1]] = _coerce(value)


class Config:
    """Top-level config: three sections ``dataset`` / ``model`` / ``pipeline``."""

    def __init__(self, cfg_dict=None):
        cfg_dict = cfg_dict or {}
        if isinstance(cfg_dict, Config):
            cfg_dict = cfg_dict.cfg_dict.to_dict()
        self.cfg_dict = ConfigDict(cfg_dict)

    def __getattr__(self, key):
        # only called when normal lookup fails
        return getattr(self.__dict__["cfg_dict"], key)

    def __getitem__(self, key):
        return self.cfg_dict[key]

    def get(self, key, default=None):
        return self.cfg_dict.get(key, default)

    def dump(self):
        return yaml.safe_dump(self.cfg_dict.to_dict(), sort_keys=False)

    @staticmethod
    def load_from_file(filename):
        with open(filename) as f:
            cfg_dict = yaml.safe_load(f) or {}
        return Config(cfg_dict)

    @staticmethod
    def merge_cfg_file(cfg, args=None, extra_dict=None):
        """Layer CLI args + dotted overrides onto a loaded config.

        Returns (dataset_cfg, pipeline_cfg, model_cfg) as plain ConfigDicts
        ready to be passed as **kwargs (reference: Config.merge_cfg_file,
        o3d/utils/config.py:102-138).
        """
        d = cfg.cfg_dict
        for section in ("dataset", "model", "pipeline"):
            if section not in d:
                d[section] = ConfigDict()

        if args is not None:
            if getattr(args, "device", None):
                d.pipeline.device = args.device
                d.model.device = args.device
            if getattr(args, "split", None):
                d.pipeline.split = args.split
            if getattr(args, "main_log_dir", None):
                d.pipeline.main_log_dir = args.main_log_dir
            if getattr(args, "output_dir", None):
                d.pipeline.output_dir = args.output_dir
            if getattr(args, "dataset_path", None):
                d.dataset.dataset_path = args.dataset_path
            if getattr(args, "ckpt_path", None):
                d.model.ckpt_path = args.ckpt_path

        if extra_dict:
            for key, value in extra_dict.items():
                path = key.lstrip("-").split(".")
                if path[0] in ("dataset", "model", "pipeline"):
                    _merge_into(d, path, value)
                else:
                    # bare keys merge into every section where they exist,
                    # else into pipeline
                    placed = False
                    for section in ("dataset", "model", "pipeline"):
                        if path[0] in d[section]:
                            _merge_into(d[section], path, value)
                            placed = True
                    if not placed:
                        _merge_into(d.pipeline, path, value)

        return d.dataset.copy(), d.pipeline.copy(), d.model.copy()

    @staticmethod
    def merge_module_cfg_file(args, extra_dict=None):
        """Sectionless mode: separate per-module config files given via
        --cfg_dataset / --cfg_pipeline / --cfg_model (reference:
        Config.merge_module_cfg_file, o3d/utils/config.py:141-185)."""
        merged = ConfigDict()
        for section, attr in (("dataset", "cfg_dataset"),
                              ("pipeline", "cfg_pipeline"),
                              ("model", "cfg_model")):
            path = getattr(args, attr, None)
            if path:
                with open(path) as f:
                    merged[section] = yaml.safe_load(f) or {}
            else:
                merged[section] = ConfigDict()
        cfg = Config({k: v.to_dict() if isinstance(v, ConfigDict) else v
                      for k, v in merged.items()})
        return Config.merge_cfg_file(cfg, args, extra_dict)
