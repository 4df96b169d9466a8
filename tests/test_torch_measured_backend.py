"""The experiment matrix's measured backend on the CPU: the port's
reducers wall-clocked on 4 gloo ranks, spawned once for the file (~10 s
alone, ~11 test-seconds inside the six-worker Tier-1 run).

``matrix.measure_points`` times every design's distinct bucket sizes for
ResNet-50 and MobileNet-v1 at p = 2 and 4 (the first p ranks of the
world) at 1/256 of their bytes, and plays the tables through the model
backend's timeline:

* every call's sum is exact (``group_latencies`` checks each one and
  raises otherwise; a reducer that returns a wrong sum is caught);
* rows carry ``backend == "measured"`` and exactly the model rows' keys,
  the model rows' bucket counts, and a finite, positive latency for
  every ``bucket_sizes`` entry;
* ``run_point(backend="measured")`` without latencies raises, as the
  reference's does; p = 1 needs none; an injected table flows through
  the same timeline; the transport must be named and the card is not
  swapped for the host.

Nothing is held about which design is faster: the host is shared.
"""
import math

import pytest
import torch

from repro_torch.core import Group
from repro_torch.experiments import matrix as mx

SCALE = 1.0 / 256
PS = (2, 4)
MODELS = ("resnet50", "mobilenet")


@pytest.fixture(scope="module")
def measured():
    points = [mx.ExperimentPoint(d, m, p) for d in mx.DESIGNS
              for m in MODELS for p in PS]
    rows = mx.measure_points(points, ("gloo",), reps=2, scale=SCALE,
                             device="cpu")
    return points, rows


def test_rows_keep_the_model_rows_keys(measured):
    points, rows = measured
    assert len(rows) == len(points)
    for pt, (transport, row) in zip(points, rows):
        model = mx.run_point(pt)
        assert transport == "gloo"
        assert row["backend"] == "measured"
        assert sorted(row) == sorted(model)
        assert row["n_buckets"] == model["n_buckets"]
        assert (row["design"], row["model"], row["p"]) == \
            (pt.design, pt.model, pt.p)
        assert math.isfinite(row["comm_s"]) and row["comm_s"] > 0
        assert math.isfinite(row["step_s"]) and row["step_s"] > 0


def test_every_bucket_size_has_a_finite_latency(measured):
    _, rows = measured
    for _, row in rows:
        sched = row["schedule"]
        lats = [b["predicted_s"] for b in sched["buckets"]]
        assert lats and all(math.isfinite(v) and v > 0 for v in lats)
        sizes = mx.bucket_sizes(row["model"], row["design"])
        assert sorted(int(b["bytes"]) for b in sched["buckets"]) == sizes


def test_a_wrong_sum_is_caught(monkeypatch):
    """One rank, no process group: the sum of 1 is 1, so a reducer that
    doubles it fails the check."""
    from repro_torch.core import reducers
    assert mx.group_latencies("Baidu_ring", Group(), [4096], reps=1,
                              device="cpu")
    monkeypatch.setattr(reducers, "allreduce",
                        lambda x, axes, strategy: x * 2)
    with pytest.raises(RuntimeError, match="not 1"):
        mx.group_latencies("Baidu_ring", Group(), [4096], reps=1,
                           device="cpu")


def test_measured_backend_composes_same_timeline():
    pt = mx.ExperimentPoint("Horovod_MPI_Opt", "resnet50", 4)
    sizes = mx.bucket_sizes("resnet50", "Horovod_MPI_Opt")
    row = mx.run_point(pt, backend="measured",
                       measured_latencies={s: 1e-3 for s in sizes})
    assert row["backend"] == "measured"
    assert row["comm_s"] == pytest.approx(row["n_buckets"] * 1e-3)
    with pytest.raises(ValueError, match="measured_latencies"):
        mx.run_point(pt, backend="measured")
    with pytest.raises(ValueError, match="backend"):
        mx.run_point(pt, backend="vibes")
    one = mx.run_point(mx.ExperimentPoint("Horovod_MPI_Opt", "resnet50", 1),
                       backend="measured")
    assert one["comm_s"] == 0.0 and one["backend"] == "measured"


def test_transport_and_device_are_the_caller_s():
    with pytest.raises(TypeError, match="transport"):
        mx.measure_design_latencies("Baidu_ring", 2, [4096])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mx.measure_points([mx.ExperimentPoint("Baidu_ring",
                                                  "resnet50", 2)],
                              ("gloo",))
