"""Base pipeline: run directories, checkpoints, summaries (port of
dmcf_tpu/pipelines/base.py).

Checkpoints hold the model's ``state_dict`` per epoch
(``<logs_dir>/checkpoint/ckpt_<epoch>.pt``) and, once training has built
them, the optimizer's and the LR schedule's, so a run resumes where it
stopped; ``scripts/jax_ckpt_to_torch.py`` turns the JAX package's orbax
checkpoints into this format.  Summaries go to TensorBoard event files
(``utils/tb_writer.py``, no TensorFlow) with scalars mirrored to a
``metrics.jsonl`` file, as in the JAX package.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
from pathlib import Path

import torch

from .. import resolve_device
from ..parallel.dist import is_main_rank
from ..utils import Config
from ..utils.log import get_runid, make_dir
from ..utils.tb_writer import TBEventWriter

log = logging.getLogger(__name__)


class SummaryLogger:
    """Summary writer: TensorBoard events (scalars and text) and a
    metrics.jsonl mirror of the scalars, one JSON object a line."""

    def __init__(self, directory):
        make_dir(directory)
        self.dir = directory
        self.jsonl = open(os.path.join(directory, "metrics.jsonl"), "a")
        self.tb = TBEventWriter(directory)

    def scalar(self, tag, value, step):
        value = float(value)
        self.tb.scalar(tag, value, step)
        self.jsonl.write(json.dumps({"tag": tag, "value": value,
                                     "step": int(step)}) + "\n")

    def text(self, tag, value, step=0):
        self.tb.text(tag, value, step)

    def flush(self):
        self.tb.flush()
        self.jsonl.flush()

    def close(self):
        self.tb.close()
        self.jsonl.close()


class NullSummary:
    """The summary writer of a rank other than 0: writes nothing."""

    def scalar(self, tag, value, step):
        pass

    def text(self, tag, value, step=0):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class BasePipeline:
    """Run-dir management, checkpoint save/load, summary plumbing.

    ``model`` is a port module already on ``device`` (default "cuda",
    which raises without a GPU).  Under several ranks only rank 0 writes
    the run's config and summaries."""

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
        self.optimizer = self.scheduler = None  # built by run_train

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

        main = is_main_rank()
        if config is not None and main:
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
        self.writer = (SummaryLogger(self.tensorboard_dir) if main
                       else NullSummary())
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
        state = {"model": self.model.state_dict(), "epoch": int(epoch)}
        if self.optimizer is not None:
            state["optimizer"] = self.optimizer.state_dict()
            state["scheduler"] = self.scheduler.state_dict()
        torch.save(state, self._ckpt_path(epoch))
        keep = int(self.cfg.get("max_ckpt_to_keep", 100))
        for old in self._saved_epochs()[:-keep]:
            os.remove(self._ckpt_path(old))
        log.info("Saved checkpoint at epoch %d", epoch)

    def _restore(self, path):
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        if self.optimizer is not None and "optimizer" in state:
            self.optimizer.load_state_dict(state["optimizer"])
            self.scheduler.load_state_dict(state["scheduler"])
        return int(state["epoch"])

    def load_ckpt(self, ckpt_path=None, is_resume=True):
        """Restore the model's weights (and the optimizer's and schedule's
        state, when the checkpoint has them and training built them).
        Returns the epoch to resume from:
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
