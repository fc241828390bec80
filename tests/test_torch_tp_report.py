"""The collective report (`ecgmm_torch/tools/tp_report.py`, the port of
`ecgmm_tpu/tools/tp_report.py`) on the CPU over gloo: one narrow `fusion`
train step on a 2 x 2 (data x model) world and on a 4 x 1 one.

The counts of the weight collectives equal those the parameter set
predicts (`expected_counts`: one gather per sharded parameter, the
gradient buckets over the data axis), with their bytes, and no other
weight collective runs (the gathers' backward keeps each rank's block
with none); a rank's parameter bytes
are `tp_bytes_per_device`'s; every rank's loss is the same. JAX reads its
numbers from the partitioned HLO and has no such count to hold this to;
its own test (`tests/test_tp_report.py`) checks its parser. The file's
top-level imports hold no JAX.
"""

import pytest
import torch

from ecgmm_torch.config import ModelConfig
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.parallel import tp
from ecgmm_torch.tools import tp_report

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=[(2, 2), (4, 1)],
                ids=["dp2xtp2", "dp4"])
def report(request):
    n_data, n_model = request.param
    return tp_report.report(n_data, n_model, "cpu", bs=8, img=32,
                            signal_len=256)


def test_weight_collectives_equal_the_plan(report):
    counts, want = report["counts"], report["expected"]
    for op, c in want.items():
        assert counts[op] == c, op
    if report["n_model"] > 1:
        assert want["all_gather_shard"]["calls"] > 0
    else:
        assert "all_gather_shard" not in counts
    assert set(counts) - set(want) == {"all_reduce_sum", "gather_rows"}
    assert counts["all_reduce"]["calls"] == want["all_reduce"]["calls"]


def test_rank_bytes_and_losses(report):
    model = ECGMultimodalModel(ModelConfig(dtype="float32"))
    assert report["param_bytes"] == tp.tp_bytes_per_device(model, 1)
    assert report["param_bytes_per_rank"] == tp.tp_bytes_per_device(
        model, report["n_model"])
    if report["n_model"] > 1:
        assert report["param_bytes_per_rank"] < report["param_bytes"]
    assert len(set(report["losses"])) == 1


def test_data_parallel_collectives_are_counted(report):
    """The BatchNorm moments (forward and backward) and the gathered rows
    of the loss run on every data-parallel step."""
    counts = report["counts"]
    assert counts["all_reduce_sum"]["calls"] > 0
    assert counts["gather_rows"]["calls"] > 0
