"""Validate / test entry point of the port (same CLI as the root
``run_pipeline.py``):

    python -m dmcf_tpu_torch.run_pipeline \
        --cfg_file configs/other/momentum.yml --split valid \
        [--device cuda|cpu] [--pipeline.a.b value ...]

A YAML config with dataset/model/pipeline sections plus dotted overrides.
``--device`` defaults to ``cuda`` and raises without a GPU; ``cpu`` runs
the plain PyTorch path.  ``--split train`` raises: training comes with a
later slice.  Weights are drawn from a ``torch.Generator`` seeded with
``pipeline.seed`` (default 42) unless a checkpoint is restored.
"""

from __future__ import annotations

import argparse
import logging
import pprint
import random
import sys

import numpy as np
import torch
import yaml


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Validate or test a model")
    parser.add_argument("-c", "--cfg_file", help="path to the config file")
    parser.add_argument("-m", "--model", help="network model")
    parser.add_argument("-p", "--pipeline", default="Simulator")
    parser.add_argument("-d", "--dataset", help="dataset")
    parser.add_argument("--cfg_model", help="path to the model config")
    parser.add_argument("--cfg_pipeline",
                        help="path to the pipeline config")
    parser.add_argument("--cfg_dataset", help="path to the dataset config")
    parser.add_argument("--dataset_path", help="path to the dataset")
    parser.add_argument("--ckpt_path", help="path to a .pt checkpoint")
    parser.add_argument("--device", default="cuda",
                        help="device to run the pipeline (cuda|cpu)")
    parser.add_argument("--split", default="train")
    parser.add_argument("--regen", default=False, action="store_true",
                        help="regenerate data, overwrite cache")
    parser.add_argument("--restart", default=False, action="store_true",
                        help="wipe the run's logs and outputs first")
    parser.add_argument("--main_log_dir")
    parser.add_argument("--output_dir")

    args, unknown = parser.parse_known_args(argv)
    extra = argparse.ArgumentParser(description="Extra arguments")
    for arg in unknown:
        if arg.startswith("-"):
            extra.add_argument(arg)
    args_extra = extra.parse_args(unknown)

    print("regular arguments")
    print(yaml.dump(vars(args)))
    print("extra arguments")
    print(yaml.dump(vars(args_extra)))
    return args, vars(args_extra)


def main(argv=None):
    """Runs the split and returns its result (the valid loss dict)."""
    cmd_line = " ".join(sys.argv if argv is None else argv)
    args, extra_dict = parse_args(argv)
    if args.split == "train":
        raise NotImplementedError(
            "--split train: training is ported in a later slice (ROADMAP "
            "queue 1 item 10)")

    random.seed(42)
    np.random.seed(42)

    from . import resolve_device
    from .data import DatasetGroup
    from .models import build_model
    from .pipelines import PIPELINES
    from .utils import Config

    device = resolve_device(args.device)
    logging.basicConfig(
        level=logging.INFO,
        format="%(levelname)s - %(asctime)s - %(module)s - %(message)s")

    if args.cfg_file is not None:
        cfg = Config.load_from_file(args.cfg_file)
        cfg_dataset, cfg_pipeline, cfg_model = Config.merge_cfg_file(
            cfg, args, extra_dict)
    elif args.cfg_model or args.cfg_pipeline or args.cfg_dataset:
        cfg_dataset, cfg_pipeline, cfg_model = Config.merge_module_cfg_file(
            args, extra_dict)
        cfg = Config({"dataset": cfg_dataset.to_dict(),
                      "pipeline": cfg_pipeline.to_dict(),
                      "model": cfg_model.to_dict()})
        if args.model:
            cfg_model.name = args.model
        if args.pipeline:
            cfg_pipeline.name = args.pipeline
    else:
        raise ValueError("please provide --cfg_file or per-module configs")

    Pipeline = PIPELINES[cfg_pipeline.get("name", "Simulator")]

    dataset = DatasetGroup(**cfg_dataset, split=args.split,
                           regen=args.regen)
    seed = int(cfg_pipeline.get("seed", 42))
    model = build_model(cfg_model, device=device,
                        generator=torch.Generator().manual_seed(seed))
    pipeline = Pipeline(model, dataset, **cfg_pipeline, config=cfg,
                        restart=args.restart,
                        model_cfg=cfg_model.to_dict())
    pipeline.writer.text("config", pprint.pformat({
        "cmd_line": cmd_line, "dataset": cfg_dataset,
        "model": cfg_model, "pipeline": cfg_pipeline}, indent=2))

    try:
        if args.split == "test":
            return pipeline.run_test()
        return pipeline.run_valid()
    finally:
        pipeline.writer.close()


if __name__ == "__main__":
    main()
