"""The port's TensorBoard event files (`ecgmm_torch/train/tfevents.py`,
written by `train/logging.MetricWriter`) against the JAX package's
`MetricWriter`, which writes through `torch.utils.tensorboard`. Both logs
are read back with tensorboard's own reader and CRC routine, never with
the port's code. This file is the only one that imports tensorboard (and
through it tensorflow, about 20 s)."""

import glob
import json
import math
import os
import re
import socket
import struct

import numpy as np
import pytest

from ecgmm_tpu.train.logging import MetricWriter as JaxMetricWriter
from ecgmm_torch.train import tfevents
from ecgmm_torch.train.logging import MetricWriter

from tensorboard.backend.event_processing import event_file_loader
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator)
from tensorboard.compat.proto import event_pb2
from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import (
    masked_crc32c)

# the scalars `train/engine.fit` and `workloads/run.py` log each epoch
FIT_TAGS = ("Loss/Train", "Loss/Val", "VarLoss/Val", "Accuracy/Val",
            "LR", "AttentionWeights/Image", "AttentionWeights/Signal",
            "AttentionWeights/Clinical")
SPECIAL = (math.nan, math.inf, -math.inf, 0.0, -0.0, 1e300, -1e-300,
           3.4028235677973366e38, 1 / 3)


def _sequence(seed: int, epochs: int = 5):
    rng = np.random.default_rng(seed)
    out = []
    for step in range(epochs):
        values = {t: float(rng.normal() * 10.0 ** rng.integers(-6, 6))
                  for t in FIT_TAGS}
        values[FIT_TAGS[step % len(FIT_TAGS)]] = SPECIAL[
            (seed + step) % len(SPECIAL)]
        out.append((step, values))
    out.append((epochs, {t: SPECIAL[i] for i, t in
                         enumerate(FIT_TAGS + ("Extra",))}))
    return out


def _write(writer_cls, log_dir, sequence, **kwargs):
    w = writer_cls(str(log_dir), **kwargs)
    for step, values in sequence:
        w.scalars(step, values)
    w.close()


def _event_file(log_dir):
    (path,) = glob.glob(os.path.join(str(log_dir), "events.out.tfevents.*"))
    return path


def _records(path):
    """The TFRecords of a file, each CRC checked with tensorboard's
    masked_crc32c."""
    with open(path, "rb") as f:
        data = f.read()
    pos, out = 0, []
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        body = data[pos + 12:pos + 12 + n]
        (dcrc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        assert hcrc == masked_crc32c(header)
        assert dcrc == masked_crc32c(body)
        out.append(body)
        pos += 16 + n
    assert pos == len(data)
    return out


def _scalars(path):
    """(tag, step, float32 value) of every scalar event, in file order,
    read by tensorboard's event_file_loader."""
    out = []
    for ev in event_file_loader.LegacyEventFileLoader(path).Load():
        for v in ev.summary.value:
            out.append((v.tag, ev.step, np.float32(v.simple_value)))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (ta, sa, va), (tb, sb, vb) in zip(a, b):
        assert (ta, sa) == (tb, sb)
        assert va.tobytes() == vb.tobytes() or (np.isnan(va)
                                                and np.isnan(vb))


@pytest.mark.parametrize("seed", range(4))
def test_event_file_reads_back_as_jax_metric_writers(tmp_path, seed):
    """Same tags, steps, float32 values (NaN, the infinities, overflow
    past float32 and -0.0 among them) and order through tensorboard's
    loader and its EventAccumulator; every record's CRCs valid."""
    seq = _sequence(seed)
    _write(JaxMetricWriter, tmp_path / "jax", seq)
    _write(MetricWriter, tmp_path / "port", seq)
    jax_path, port_path = (_event_file(tmp_path / d) for d in ("jax",
                                                                "port"))
    # record for record the same events once the wall times are cleared
    events = []
    for path in (jax_path, port_path):
        events.append([])
        for body in _records(path):
            ev = event_pb2.Event.FromString(body)
            ev.wall_time = 0
            events[-1].append(ev.SerializeToString())
    assert events[0] == events[1]
    want, got = _scalars(jax_path), _scalars(port_path)
    assert len(got) == sum(len(v) for _, v in seq)
    _same(got, want)
    accs = [EventAccumulator(str(tmp_path / d)) for d in ("jax", "port")]
    for acc in accs:
        acc.Reload()
    assert accs[0].Tags()["scalars"] == accs[1].Tags()["scalars"]
    for tag in accs[0].Tags()["scalars"]:
        a, b = (acc.Scalars(tag) for acc in accs)
        assert [e.step for e in a] == [e.step for e in b]
        np.testing.assert_array_equal(
            np.float32([e.value for e in a]),
            np.float32([e.value for e in b]))
    # metrics.jsonl is unchanged: one line a step, the same keys
    lines = [json.loads(x) for x in
             open(tmp_path / "port" / "metrics.jsonl")]
    assert [ln["step"] for ln in lines] == [s for s, _ in seq]


def test_records_are_the_protobuf_bytes(tmp_path):
    """Each record, parsed with tensorboard's event_pb2 and serialized
    again, gives the port's bytes: the hand-written field encoding is
    protobuf's. The first event carries the file version and the source
    writer as tensorboard's EventFileWriter writes them."""
    _write(MetricWriter, tmp_path, _sequence(7))
    records = _records(_event_file(tmp_path))
    first = event_pb2.Event.FromString(records[0])
    assert first.file_version == "brain.Event:2"
    assert first.source_metadata.writer == tfevents.SOURCE_WRITER
    assert first.wall_time > 0
    for body in records:
        assert event_pb2.Event.FromString(body).SerializeToString() == body
    steps = [event_pb2.Event.FromString(b).step for b in records[1:]]
    assert steps == sorted(steps) and steps[0] == 0


def test_event_file_name_and_switch(tmp_path):
    """The name follows tensorboard's pattern; `use_tensorboard=False`
    writes metrics.jsonl alone, as JAX's writer does."""
    _write(MetricWriter, tmp_path / "a", _sequence(0, 1))
    name = os.path.basename(_event_file(tmp_path / "a"))
    m = re.fullmatch(r"events\.out\.tfevents\.(\d{10})\.(.+)\.(\d+)\.(\d+)",
                     name)
    assert m and m.group(2) == socket.gethostname()
    assert int(m.group(3)) == os.getpid()
    _write(MetricWriter, tmp_path / "b", _sequence(0, 1),
           use_tensorboard=False)
    assert os.listdir(tmp_path / "b") == ["metrics.jsonl"]


@pytest.mark.parametrize("data", [b"", b"a", b"123456789", bytes(range(256))])
def test_crc32c_matches_tensorboards(data):
    assert tfevents.masked_crc32c(data) == masked_crc32c(data)
