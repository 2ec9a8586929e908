"""Base pipeline: run directories, checkpoints, scalar summaries (port of
dmcf_tpu/pipelines/base.py).

Checkpoints are the model's ``state_dict`` per epoch
(``<logs_dir>/checkpoint/ckpt_<epoch>.pt``); the JAX package's orbax
checkpoints are not read (ROADMAP queue 1 item 12).  Scalars go to a
``metrics.jsonl`` file, the JAX package's JSONL mirror; its tensorboard
event files are left out.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import shutil
from pathlib import Path

import torch

from .. import resolve_device
from ..utils import Config

log = logging.getLogger(__name__)


def make_dir(path):
    os.makedirs(path, exist_ok=True)


def get_runid(path):
    """Next 5-digit run id for a summary directory family."""
    name = os.path.basename(path)
    parent = os.path.dirname(path) or "."
    if not os.path.exists(parent):
        return "00001"
    best = 0
    pattern = re.compile(r"^(\d{5})_" + re.escape(name) + r"$")
    for entry in os.listdir(parent):
        m = pattern.match(entry)
        if m:
            best = max(best, int(m.group(1)))
    return "%05d" % (best + 1)


class SummaryLogger:
    """Scalar summary writer: one JSON object a line in metrics.jsonl."""

    def __init__(self, directory):
        make_dir(directory)
        self.dir = directory
        self.jsonl = open(os.path.join(directory, "metrics.jsonl"), "a")

    def scalar(self, tag, value, step):
        self.jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                     "step": int(step)}) + "\n")

    def text(self, tag, value, step=0):
        self.jsonl.write(json.dumps({"tag": tag, "text": str(value),
                                     "step": int(step)}) + "\n")

    def flush(self):
        self.jsonl.flush()

    def close(self):
        self.jsonl.close()


class BasePipeline:
    """Run-dir management, checkpoint save/load, summary plumbing.

    ``model`` is a port module already on ``device`` (default "cuda",
    which raises without a GPU)."""

    def __init__(self, model, dataset=None, config=None, restart=False,
                 **kwargs):
        if kwargs.get("name") is None:
            raise KeyError("pipeline needs a name")
        self.cfg = Config(kwargs)
        self.name = self.cfg.name
        self.version = self.cfg.get("version", "v0")
        self.device = resolve_device(self.cfg.get("device") or "cuda")
        self.model = model
        self.dataset = dataset
        self.model_cfg = kwargs.get("model_cfg", {})

        make_dir(self.cfg.main_log_dir)
        dataset_name = dataset.name if dataset is not None else ""
        tag = f"{type(model).__name__}_{dataset_name}_{self.version}"
        self.cfg.logs_dir = os.path.join(self.cfg.main_log_dir, tag)
        if restart and os.path.exists(self.cfg.logs_dir):
            shutil.rmtree(self.cfg.logs_dir)
        make_dir(self.cfg.logs_dir)

        make_dir(self.cfg.output_dir)
        self.cfg.out_dir = os.path.join(self.cfg.output_dir, tag)
        if restart and os.path.exists(self.cfg.out_dir):
            shutil.rmtree(self.cfg.out_dir)
        make_dir(self.cfg.out_dir)

        if config is not None:
            with open(os.path.join(self.cfg.logs_dir, "config.txt"),
                      "w") as f:
                f.write(config.dump() if hasattr(config, "dump")
                        else str(config))

        tb_base = os.path.join(self.cfg.get("train_sum_dir", "./train_log"),
                               tag)
        runid = get_runid(tb_base)
        self.tensorboard_dir = os.path.join(
            self.cfg.get("train_sum_dir", "./train_log"),
            runid + "_" + Path(tb_base).name)
        self.writer = SummaryLogger(self.tensorboard_dir)
        self._ckpt_dir = os.path.abspath(
            os.path.join(self.cfg.logs_dir, "checkpoint"))

    # -- checkpointing --------------------------------------------------

    def _ckpt_path(self, epoch):
        return os.path.join(self._ckpt_dir, "ckpt_%05d.pt" % epoch)

    def _saved_epochs(self):
        found = glob.glob(os.path.join(self._ckpt_dir, "ckpt_*.pt"))
        return sorted(int(os.path.basename(p)[5:-3]) for p in found)

    def save_ckpt(self, epoch):
        make_dir(self._ckpt_dir)
        torch.save({"model": self.model.state_dict(), "epoch": int(epoch)},
                   self._ckpt_path(epoch))
        keep = int(self.cfg.get("max_ckpt_to_keep", 100))
        for old in self._saved_epochs()[:-keep]:
            os.remove(self._ckpt_path(old))
        log.info("Saved checkpoint at epoch %d", epoch)

    def _restore(self, path):
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        return int(state["epoch"])

    def load_ckpt(self, ckpt_path=None, is_resume=True):
        """Restore the model's weights.  Returns the epoch to resume from:
        0 for an explicit ``ckpt_path`` (a .pt file), else the latest saved
        epoch's successor, else 0 with the weights as built."""
        if ckpt_path:
            self._restore(ckpt_path)
            log.info("Restored from %s", ckpt_path)
            return 0
        epochs = self._saved_epochs()
        if epochs and is_resume:
            self._restore(self._ckpt_path(epochs[-1]))
            log.info("Restored from checkpoint epoch %d", epochs[-1])
            return epochs[-1] + 1
        log.info("Initializing from scratch.")
        return 0

    # -- logging --------------------------------------------------------

    def save_logs(self, writer, step, data, prefix=""):
        for d in data:
            for key, val in d.items():
                writer.scalar(os.path.join(prefix, key), val, step)
        writer.flush()
