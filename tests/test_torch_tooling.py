"""The port's host tooling against the JAX package's, on the CPU:

* ``utils/tb_writer.TBEventWriter`` and ``pipelines.base.SummaryLogger``:
  with ``time.time`` fixed, the same ``scalar`` and ``text`` calls give
  event files and ``metrics.jsonl`` files byte for byte equal to the JAX
  package's (text goes to the events file only); every record's masked
  CRC32C verifies (``read_records``) and decodes to its call
  (``read_events``);
* ``utils.log`` (``LogRecord``'s brace formatting, ``get_runid``,
  ``setup_logging``) and ``utils.cache`` (``get_hash``, ``Cache``);
* ``data.get_normalization_stats`` on a generated dataset;
* ``viz.draw2d.render``: the same pixels on a small hdf5 file that the
  port's ``write_results`` writes, as a strip and as per-frame files.
"""

import json
import logging
import os
import time

import numpy as np
import pytest
import torch

from dmcf_tpu.data.dataflow import get_normalization_stats as jax_stats
from dmcf_tpu.pipelines.base import SummaryLogger as JaxSummaryLogger
from dmcf_tpu.utils import cache as jcache
from dmcf_tpu.utils import log as jlog
from dmcf_tpu.utils.tb_writer import TBEventWriter as JaxTBEventWriter
from dmcf_tpu.viz import draw2d as jdraw
from dmcf_tpu_torch.data import get_normalization_stats, write_results
from dmcf_tpu_torch.pipelines.base import SummaryLogger
from dmcf_tpu_torch.utils import Cache, LogRecord, get_hash, get_runid, \
    setup_logging
from dmcf_tpu_torch.utils.tb_writer import (TBEventWriter, read_events,
                                            read_records)
from dmcf_tpu_torch.viz import draw2d

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

CALLS = [("scalar", "train/loss", 0.125, 0), ("text", "config",
                                              "{'a': 1}\nline two", 0),
         ("scalar", "valid/mse", np.float32(3.5e-7), 12),
         ("scalar", "train/learning_rate", -1e-3, 2 ** 40),
         ("text", "notes", "ünïcode", 7)]


def emit(writer):
    for kind, tag, value, step in CALLS:
        getattr(writer, kind)(tag, value, step)
    writer.flush()


def only_file(directory, prefix):
    names = [n for n in os.listdir(directory) if n.startswith(prefix)]
    assert len(names) == 1, names
    return os.path.join(directory, names[0])


@pytest.mark.parametrize("which", ["event_writer", "summary_logger"])
def test_event_files_equal_jax(which, tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    if which == "event_writer":
        writers = [TBEventWriter(str(ours)), JaxTBEventWriter(str(theirs))]
    else:
        writers = [SummaryLogger(str(ours)), JaxSummaryLogger(str(theirs))]
    for w in writers:
        emit(w)
    got = only_file(ours, "events.out.tfevents.")
    want = only_file(theirs, "events.out.tfevents.")
    assert os.path.basename(got) == os.path.basename(want)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    records = read_records(got)
    assert len(records) == 1 + len(CALLS)
    assert records[0].endswith(b"brain.Event:2")
    events = read_events(got)
    assert events[0] == {"step": 0, "wall_time": 1700000000.25,
                         "file_version": "brain.Event:2"}
    for ev, (kind, tag, value, step) in zip(events[1:], CALLS):
        assert (ev["tag"], ev["step"]) == (tag, step)
        if kind == "scalar":
            assert ev["value"] == float(np.float32(value))
        else:
            assert ev["text"] == value
    if which == "summary_logger":
        with open(ours / "metrics.jsonl") as a, \
                open(theirs / "metrics.jsonl") as b:
            lines = a.read()
            assert lines == b.read()
        scalars = [c for c in CALLS if c[0] == "scalar"]
        assert [json.loads(ln) for ln in lines.splitlines()] == [
            {"tag": t, "value": float(v), "step": s}
            for _, t, v, s in scalars]
        writers[0].close()


def test_read_records_rejects_a_flipped_byte(tmp_path):
    w = TBEventWriter(str(tmp_path))
    w.scalar("a", 1.0, 1)
    w.close()
    path = only_file(tmp_path, "events.out.tfevents.")
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 1
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_records(path)


def test_log_helpers_match_jax(tmp_path):
    args = ("x {} and {:.2f}", (3, 0.5))
    got = LogRecord("n", logging.INFO, "p", 1, *args, None).getMessage()
    want = jlog.LogRecord("n", logging.INFO, "p", 1, *args,
                          None).getMessage()
    assert got == want == "x 3 and 0.50"
    base = tmp_path / "sum" / "SymNet_data_v0"
    assert get_runid(str(base)) == jlog.get_runid(str(base)) == "00001"
    for name in ("00001_SymNet_data_v0", "00007_SymNet_data_v0",
                 "00009_other", "x_SymNet_data_v0"):
        os.makedirs(tmp_path / "sum" / name)
    assert get_runid(str(base)) == jlog.get_runid(str(base)) == "00008"
    factory = logging.getLogRecordFactory()
    try:
        setup_logging()
        assert logging.getLogRecordFactory() is LogRecord
        assert logging.getLogger().level == logging.INFO
    finally:
        logging.setLogRecordFactory(factory)


def test_cache_matches_jax(tmp_path):
    for s in ("", "abc", "configs/WaterRamps.yml{'a': 1}"):
        assert get_hash(s) == jcache.get_hash(s)
    calls = []

    def func(a, b):
        calls.append((a, b))
        return {"sum": np.arange(3) + a + b}

    results = {}
    for name, cls in (("port", Cache), ("jax", jcache.Cache)):
        c = cls(func, str(tmp_path / name), get_hash("k"))
        first = c("s0", 1, 2)
        again = c("s0", 5, 5)          # cached: func is not called
        other = c("s1", 0, 1)
        fresh = cls(func, str(tmp_path / name), get_hash("k"))
        results[name] = (first, again, other, sorted(c.cached_ids),
                         sorted(fresh.cached_ids), fresh("s1", 9, 9))
    assert calls == [(1, 2), (0, 1)] * 2
    got, want = results["port"], results["jax"]
    for g, w in zip(got, want):
        if isinstance(w, dict):
            np.testing.assert_array_equal(g["sum"], w["sum"])
        else:
            assert g == w
    assert got[4] == ["s0", "s1"]
    np.testing.assert_array_equal(got[1]["sum"], [3, 4, 5])


def test_normalization_stats_match_jax():
    rng = np.random.RandomState(0)
    scenes = []
    for s, (t, n) in enumerate(((6, 10), (9, 4), (5, 7))):
        walk = np.cumsum(rng.randn(t, n, 3).astype(np.float32) * 0.01, 0)
        scenes.append([{"pos": walk[i], "frame_id": i + s}
                       for i in range(t)])
    got = get_normalization_stats(scenes, 0.0025)
    want = jax_stats(scenes, 0.0025)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["sequence_length"] == 9      # the largest frame_id


@pytest.mark.parametrize("mode", ["strip", "frames"])
def test_draw2d_gives_jax_pixels(mode, tmp_path):
    import matplotlib.pyplot as plt

    rng = np.random.RandomState(0)
    gt = rng.rand(6, 40, 3).astype(np.float32) * 0.5
    pred = gt + rng.normal(scale=0.01, size=gt.shape).astype(np.float32)
    pred[2, 3] = 1000.0                       # an inactive row
    line = np.linspace(-0.1, 0.6, 30)       # a floor and a wall
    bnd = np.concatenate([
        np.stack([line, np.full(30, -0.05), np.zeros(30)], -1),
        np.stack([np.full(30, -0.1), line, np.zeros(30)], -1)]).astype(
            np.float32)
    path = str(tmp_path / "rollout.hdf5")
    write_results(path, "SymNet", [
        (pred, {"name": "pred", "type": "PARTICLE"}),
        (gt, {"name": "gt", "type": "PARTICLE"}),
        (bnd, {"name": "bnd", "type": "PARTICLE"})])
    pixels = {}
    for name, mod in (("port", draw2d), ("jax", jdraw)):
        out = tmp_path / name
        if mode == "strip":
            mod.render(path, str(out / "strip.png"), num_frames=3,
                       height=60)
            files = [out / "strip.png"]
        else:
            mod.render(path, out_pattern=str(out / "{pointset}_{frame}.png"),
                       frames=[0, 2], height=48, particle_radius=0.01)
            files = sorted(out.iterdir())
        pixels[name] = [(f.name, plt.imread(str(f))) for f in files]
    assert [n for n, _ in pixels["port"]] == [n for n, _ in pixels["jax"]]
    for (_, got), (_, want) in zip(pixels["port"], pixels["jax"]):
        assert got.shape == want.shape and got.shape[0] > 10
        np.testing.assert_array_equal(got, want)
        assert got.min() < got.max()             # something was drawn
