"""``run_pipeline --split train`` of the port under data parallelism
(``pipeline.data_parallel: true``, ``Simulator._setup_data_parallel``) on
2 gloo ranks (``parallel.dist.spawn``; rank bodies in ``_torch_ranks.py``)
against a single-process run of the same config on the same seeded
batches, on the CPU (``configs/other/momentum.yml``, data scaled by 0.9).

Both ranks log the single-process run's losses (rtol 2e-4, JAX's
``test_parallel.py`` loss tolerance: the gradients are summed in another
order), rank 0 alone writes the checkpoint, and the summaries are one
run's.
"""

import os

import numpy as np
import torch

from dmcf_tpu_torch import run_pipeline
from dmcf_tpu_torch.parallel.dist import spawn

import _torch_ranks

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

MOMENTUM = os.path.join(os.path.dirname(__file__), "..", "configs", "other",
                        "momentum.yml")


def test_run_pipeline_data_parallel(tmp_path):
    args = ["--cfg_file", MOMENTUM, "--split", "train", "--device", "cpu",
            "--main_log_dir", "logs", "--output_dir", "out",
            "--pipeline.train_sum_dir", "sum", "--pipeline.iter", "2",
            "--pipeline.log_every", "1", "--dataset.cache_dir", "none",
            "--dataset.train.data_cnt", "1", "--dataset.train.timesteps",
            "6", "--pipeline.data_generator.scale", "[0.9,0.9,0.0]",
            "--pipeline.data_generator.train.seed", "0",
            "--pipeline.run_valid_every_epoch", "false",
            "--pipeline.run_test_every_epoch", "false",
            "--pipeline.max_epoch", "0", "--pipeline.batch_size", "2",
            "--pipeline.windows", "[1]"]
    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir()
    two.mkdir()
    cwd = os.getcwd()
    os.chdir(one)
    try:
        want = run_pipeline.main(args)
    finally:
        os.chdir(cwd)
    ranks = spawn(_torch_ranks.run_pipeline_main, 2,
                  args=(str(two), args + ["--pipeline.data_parallel",
                                          "true"]))
    for r in ranks:
        assert [e["step"] for e in r["logged"]] == [0, 1]
        np.testing.assert_allclose([e["loss"] for e in r["logged"]],
                                   [e["loss"] for e in want], rtol=2e-4)
    assert ranks[0]["ckpts"] == ["ckpt_00000.pt"]
    assert sorted(os.listdir(two / "sum")) == sorted(os.listdir(one / "sum"))
