"""The port's train loop as the JAX package's runs it (``Simulator.
run_train``), on the CPU at ``test_run_pipeline_train_writes_metrics_and_
resumes``'s data size, the model cut to ``test_torch_train.py``'s narrow
two-scale SymNet (``NARROW_ARGS``), window 2: the one-deep batch
prefetch, the deferred log flush (``log_flush_steps``), the profiler
capture (``profile_step``) and the section timing
(``DMCF_LOOP_TIMING=1``) change no train scalar or logged entry, bit for
bit; the capture writes one Chrome trace, of its step
only; the timing logs one line a log interval with JAX's five sections;
an overflow in a queued entry raises at the flush; a curriculum rebuild
drops the prefetched batch; ``data_parallel: true`` over a world of one
trains on.

JAX's train step is held against this loop's step in
``test_torch_train.py::test_train_step_matches_jax``; a JAX run of the
whole loop is not added here, for want of room in the suite's time.
The loader is seeded (``data_generator.train.seed``): unseeded, its
streams draw from the OS's entropy and two runs train on other
batches."""

import copy
import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

from dmcf_tpu_torch import run_pipeline
from dmcf_tpu_torch.pipelines import simulator as sim
from dmcf_tpu_torch.profile_step import HAND_KERNELS, trace_file_summary
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.models.losses import get_loss
from dmcf_tpu_torch.rollout import rollout
from tests.test_torch_train import NARROW_ARGS, narrow_cfg

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
MOMENTUM = os.path.join(ROOT, "configs", "other", "momentum.yml")
SECTIONS = ("fetch", "dispatch", "prefetch", "log", "other")


def train(tmp_path, name, *extra, iters=3, k=16, windows="[2]"):
    """``run_pipeline --split train`` of ``iters`` steps of one item into
    ``tmp_path/name``, the finest radius's budget ``k``, the curriculum's
    ``windows``: (the logged entries, the metrics.jsonl train records,
    the run's log directory)."""
    out = tmp_path / name
    narrow = list(NARROW_ARGS)
    narrow[narrow.index("--model.neighbor_k") + 1] = str(k)
    logged = run_pipeline.main([
        "--cfg_file", MOMENTUM, "--split", "train", "--device", "cpu",
        "--main_log_dir", str(out / "logs"), "--output_dir",
        str(out / "out"), "--pipeline.train_sum_dir", str(out / "sum"),
        "--pipeline.iter", str(iters), "--pipeline.max_epoch", "0",
        "--pipeline.log_every", "1", "--dataset.cache_dir", "none",
        "--dataset.train.data_cnt", "1", "--dataset.train.timesteps", "8",
        "--dataset.valid.data_cnt", "1", "--dataset.valid.timesteps", "3",
        "--dataset.test.data_cnt", "1", "--dataset.test.timesteps", "2",
        "--pipeline.data_generator.scale", "[0.9,0.9,0.0]",
        "--pipeline.run_valid_every_epoch", "false",
        "--pipeline.run_test_every_epoch", "false",
        "--pipeline.batch_size", "1",
        "--pipeline.data_generator.train.seed", "0", *narrow,
        "--pipeline.windows", windows, *extra])
    (logs,) = glob.glob(str(out / "logs" / "*"))
    (metrics,) = glob.glob(str(out / "sum" / "*" / "metrics.jsonl"))
    with open(metrics) as f:
        records = [r for r in map(json.loads, f)
                   if r["tag"].startswith("train/")]
    return logged, records, logs


def timing_lines(logs):
    (path,) = glob.glob(os.path.join(logs, "log_train_*.txt"))
    with open(path) as f:
        return [ln for ln in f if "loop timing (s since last):" in ln]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three runs of three steps: ``off`` (no option), ``flush1``
    (``profile_step: 1``, ``DMCF_LOOP_TIMING=1``, ``log_flush_steps: 1``)
    and ``flush1000`` (the same with ``log_flush_steps: 1000`` and
    ``data_parallel: true`` over a world of one).  The package's INFO
    records reach each run's log file (pytest keeps the root logger at
    WARNING, so ``run_pipeline``'s basicConfig does nothing)."""
    tmp = tmp_path_factory.mktemp("loop")
    pkg = logging.getLogger("dmcf_tpu_torch")
    level = pkg.level
    pkg.setLevel(logging.INFO)
    try:
        out = {"off": train(tmp, "off")}
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DMCF_LOOP_TIMING", "1")
            out["flush1"] = train(tmp, "flush1", "--pipeline.profile_step",
                                  "1", "--pipeline.log_flush_steps", "1")
            out["flush1000"] = train(
                tmp, "flush1000", "--pipeline.profile_step", "1",
                "--pipeline.log_flush_steps", "1000",
                "--pipeline.data_parallel", "true")
    finally:
        pkg.setLevel(level)
    return out


def test_loop_options_change_no_scalar(runs):
    base, records, _ = runs["off"]
    assert [e["step"] for e in base] == [0, 1, 2]
    assert all(np.isfinite(e["loss"]) for e in base)
    for name in ("flush1", "flush1000"):
        got, got_records, _ = runs[name]
        assert got == base, name
        assert got_records == records, name


def test_capture_writes_one_trace_of_its_step(runs):
    assert not os.path.exists(os.path.join(runs["off"][2], "profile"))
    for name, file in (("flush1", "train_step_1.json"),
                       ("flush1000", "train_step_1_rank0.json")):
        assert os.listdir(os.path.join(runs[name][2], "profile")) == [file]
    with open(os.path.join(runs["flush1"][2], "profile",
                           "train_step_1.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    summary = trace_file_summary(os.path.join(runs["flush1"][2], "profile",
                                              "train_step_1.json"))
    assert summary["device_events"] == 0
    assert summary["profiled_ms_per_step"] > 0


def test_trace_file_summary_counts_device_events(tmp_path):
    """The summary of a Chrome trace: the window is its events' span, the
    device time the device events' summed time, each hand kernel counted
    by its symbol, memsets and copies apart from the kernels."""
    def event(cat, name, ts, dur, ph="X"):
        return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [event("cpu_op", "aten::mm", 0, 100),
              event("kernel", "void cconv_klist_kernel<true>(Params)", 10,
                    20),
              event("kernel", "cconv_klist_bwd_dT_kernel", 30, 11),
              event("kernel", "cconv_klist_bwd_dT_kernel", 41, 11),
              event("kernel", "cconv_klist_bwd_dT_kernel_v2", 50, 1),
              event("gpu_memset", "Memset (Device)", 55, 5),
              event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 60, 14),
              event("cuda_runtime", "cudaLaunchKernel", 5, 2),
              event("kernel", "cconv_klist_kernel", 200, 0, ph="i")]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace_file_summary(str(path), top=2)
    assert s["profiled_ms_per_step"] == pytest.approx(0.1)
    assert s["device_ms_per_step"] == pytest.approx(0.062)
    assert s["device_busy_share"] == pytest.approx(0.62)
    assert (s["kernel_launches_per_step"], s["device_events"],
            s["memsets"]) == (4, 6, 1)
    assert s["hand_kernels"] == dict(
        dict.fromkeys(HAND_KERNELS, 0), cconv_klist_kernel=1,
        cconv_klist_bwd_dT_kernel=2)
    assert [(r["name"], r["calls_per_step"]) for r in s["top_kernels"]] == [
        ("cconv_klist_bwd_dT_kernel", 2),
        ("void cconv_klist_kernel<true>(Params)", 1)]


def test_loop_timing_logs_one_line_a_log_interval(runs):
    assert timing_lines(runs["off"][2]) == []
    for name in ("flush1", "flush1000"):
        lines = timing_lines(runs[name][2])
        assert len(lines) == 3
        for ln in lines:
            keys = [kv.split("=")[0] for kv in ln.split(": ")[-1].split()]
            assert keys == list(SECTIONS)


def test_data_parallel_world_of_one_trains_on(runs):
    logged, _, _ = runs["flush1000"]
    assert [e["step"] for e in logged] == [0, 1, 2]
    assert all(np.isfinite(e["loss"]) for e in logged)
    assert not torch.distributed.is_initialized()


def test_overflow_in_a_queued_entry_raises_at_the_flush(tmp_path,
                                                       monkeypatch):
    flushed = []
    real = sim.Simulator._flush_train_logs

    def flush(self, queue):
        flushed.append([e[0] for e in queue])
        return real(self, queue)

    monkeypatch.setattr(sim.Simulator, "_flush_train_logs", flush)
    with pytest.raises(RuntimeError, match="neighbor overflow at train "
                                           "step 0"):
        train(tmp_path, "overflow", "--pipeline.strict_overflow", "true",
              iters=2, k=2)
    assert flushed == [[0, 1]]   # both steps ran, read back at the end


def test_curriculum_rebuild_drops_the_prefetched_batch(tmp_path,
                                                       monkeypatch):
    drawn, fed = [], []
    real_loader = sim.get_dataloader

    def loader(*args, **kw):
        it, mine = real_loader(*args, **kw), []
        drawn.append(mine)

        class Counting:
            def __next__(self):
                batch = next(it)
                mine.append(batch["pos"].shape)
                return batch

            def close(self):
                it.close()
        return Counting()

    real_step = sim.Simulator._make_train_step

    def make_step(self, *args):
        step = real_step(self, *args)

        def counted(batch, time_w):
            fed.append(tuple(batch["pos"].shape))
            return step(batch, time_w)
        return counted

    monkeypatch.setattr(sim, "get_dataloader", loader)
    monkeypatch.setattr(sim.Simulator, "_make_train_step", make_step)
    logged, _, _ = train(tmp_path, "curriculum", "--pipeline.window_bnds",
                         "[1]", iters=2, windows="[2,3]")
    assert [e["step"] for e in logged] == [0, 1]
    assert all(np.isfinite(e["loss"]) for e in logged)
    # loader 1: step 0's batch and the prefetch the rebuild drops;
    # loader 2: step 1's batch and the next prefetch
    assert [len(d) for d in drawn] == [2, 2]
    assert fed == [drawn[0][0], drawn[1][0]]
    assert drawn[0][1] != drawn[1][0]   # window 2 vs window 3 frames


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_step_on_copies_of_one_item_is_its_one_item_step(precision):
    """A train step on two copies of one sequence gives the one-item
    step's loss and gradients bit for bit (each item's gradient is scaled
    by 1 / items, a power of two): ``chip_smoke.py`` holds the card's
    two-item option steps against the CPU's one-item step on that."""
    import yaml
    with open(MOMENTUM) as f:
        cfg = yaml.safe_load(f)
    model = build_model(dict(narrow_cfg(), precision=precision),
                        device="cpu",
                        generator=torch.Generator().manual_seed(0))
    g = np.random.RandomState(0)
    n, nb, window = 120, 40, 3
    pos = torch.tensor(g.uniform(0.2, 0.8, (n, 3)), dtype=torch.float32)
    box = torch.tensor(g.uniform(0.0, 1.0, (nb, 3)), dtype=torch.float32)
    pos[:, 2] = box[:, 2] = 0.0
    sample = {"pos": pos, "vel": torch.zeros(n, 3), "box": box,
              "box_normals": torch.tensor([[0.0, 1.0, 0.0]]).repeat(nb, 1),
              "fluid_mask": torch.ones(n, dtype=torch.bool),
              "box_mask": torch.ones(nb, dtype=torch.bool)}
    frames = (torch.empty((window + 1, n, 3)), torch.empty((window + 1, n, 3)))
    with torch.no_grad():
        rollout(model, sample, window, frames=frames)
    frames[0][1:] += torch.from_numpy(g.normal(
        scale=1e-3, size=(window, n, 3)).astype(np.float32))
    loss = {k: get_loss(**v) for k, v in cfg["model"]["loss"].items()}
    got = []
    for items in (1, 2):
        batch = {k: v[None].expand(items, *v.shape).contiguous()
                 for k, v in zip(("pos", "vel"), frames)}
        for k in ("box", "box_normals", "fluid_mask", "box_mask"):
            batch[k] = sample[k][None].expand(items, *sample[k].shape)
        batch["pre"] = torch.zeros(items, dtype=torch.int32)
        m = copy.deepcopy(model)
        step = sim.make_train_step(m, loss, *sim.make_optimizer(
            m, cfg["pipeline"]["optimizer"]), window=window)
        lvec, _, _ = step(batch, np.ones(window, np.float32))
        got.append((lvec, {k: p.grad for k, p in m.named_parameters()}))
    assert torch.equal(got[0][0], got[1][0])
    assert any(bool(v.abs().sum() > 0) for v in got[0][1].values())
    for k, v in got[0][1].items():
        assert torch.equal(v, got[1][1][k]), k
