"""The work the benchmark counts, from the configurations' shapes: model
FLOPs against `FlopCounterMode` on the frozen reference, kernel bytes
against PERF.md's bound column, and the arithmetic of the idle share and
of the nearest-rank percentile on hand-made events."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import clock, inputs, spec, trace, work
from benchmark.reference import arith, models

FUSION = spec.load_config("fusion")
TRANSFORMER = spec.load_config("physionet_transformer")


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _net(config):
    net = models.build(config["reference"], config["model"], "cpu")
    inputs.make_weights(net, 0)
    return net


def _fusion_batch(b, config=FUSION):
    inp = config["inputs"]
    g = torch.Generator().manual_seed(1)
    return {"images": torch.randint(0, 256, (b, *inp["image"]), generator=g,
                                    dtype=torch.uint8),
            "signals": torch.randn(b, inp["signal_len"], generator=g),
            "clinical": torch.randn(b, inp["clinical"], generator=g),
            "labels": torch.randint(0, 2, (b,), generator=g),
            "mask": torch.ones(b)}


@pytest.mark.parametrize("b", [1, 3])
def test_fusion_encoder_flops(b):
    net = _net(FUSION)
    rc = models.RunCtx(arith.Arith(), train=False)
    x = _fusion_batch(b)
    with torch.no_grad():
        got = _counted(lambda: net.encode(x["images"], x["signals"],
                                          x["clinical"], rc))
    assert got == 2 * b * work.fusion_encoder_macs(FUSION)


def test_fusion_train_step_flops():
    """The frozen encoders' forward, and the trained head forward and
    backward (3x its forward; the count also holds the branch
    classifiers, which the fusion step trains and its loss leaves
    unread)."""
    b = 2
    net = _net(FUSION)
    rc = models.RunCtx(arith.Arith(), train=True,
                       generator=torch.Generator().manual_seed(3),
                       mask_dtype=torch.bfloat16)
    x = _fusion_batch(b)
    head = [p for n, p in net.named_parameters()
            if not n.startswith(tuple(FUSION["frozen_prefixes"]))]
    for n, p in net.named_parameters():
        p.requires_grad_(any(p is q for q in head))

    def step():
        img, sig, clin = net.encode(x["images"], x["signals"],
                                    x["clinical"], rc)
        fwd = net.fuse(img, sig, clin, rc).sum()
        fwd = fwd + sum(m(e).sum() for m, e in (
            (net.image_classifier, img), (net.signal_classifier, sig),
            (net.clinical_classifier, clin)))
        fwd.backward()

    got = _counted(step)
    enc = 2 * b * work.fusion_encoder_macs(FUSION)
    head_fwd = 2 * b * work.fusion_head_macs(FUSION["model"])
    # the first head layers take no input gradient: their inputs hold
    # no trained parameter's path back except the LayerNorms', which
    # the count takes as a product only where one exists
    assert enc + head_fwd * 2 <= got <= enc + 3 * head_fwd
    assert work.train_step_flops(FUSION, b) == enc + 3 * head_fwd


@pytest.mark.parametrize("seq_len", [3000, 640])
def test_transformer_forward_flops(seq_len):
    config = copy.deepcopy(TRANSFORMER)
    config["model"]["seq_len"] = seq_len
    net = _net(config)
    rc = models.RunCtx(arith.Arith(), train=False)
    x = torch.randn(1, seq_len)
    with torch.no_grad():
        got = _counted(lambda: net(x, rc))
    assert got == 2 * work.transformer_macs(config["model"])
    assert work.train_step_flops(config, 8) == 8 * 3 * got


def _us(bytes_):
    return round(bytes_ / work.HBM_BYTES_PER_S * 1e6, 3)


@pytest.mark.parametrize("b, esize, want", [
    # PERF.md's kernel table, `fused_se` forward rows, bound column
    (256, 2, (12.149, 12.209, 12.291)),   # B=256 bf16, K=1
    (16, 4, (1.517, 1.524, 1.536)),       # B=16 f32, K=8
    (8, 4, (0.759, 0.763, 0.773)),        # B=8 f32, signal_only
    (32, 4, (3.033, 3.045, 3.062)),       # B=32 f32, XAI encoding
])
def test_se_bytes_match_the_bound_column(b, esize, want):
    shapes = work.se_shapes(FUSION["inputs"]["signal_len"], 64)
    assert shapes == [(64, 619), (128, 310), (256, 155)]
    got = tuple(_us(work.se_forward_bytes(b, c, t, esize, residual=True))
                for c, t in shapes)
    assert got == pytest.approx(want, abs=0.0015)


def _raw(kernels, marks=(0.0, 100.0), host=()):
    """Chrome-trace events: two marker copies ending at marks[0] and
    starting at marks[1], kernels (ts, dur) and host calls (ts, dur,
    name)."""
    ev = [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": marks[0] - 1.0, "dur": 1.0,
           "args": {"bytes": trace.MARK_BYTES, "device": 0}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": marks[1], "dur": 1.0,
           "args": {"bytes": trace.MARK_BYTES, "device": 0}}]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": dur,
            "args": {"device": 0}} for ts, dur, n in kernels]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": n, "ts": ts,
            "dur": dur} for ts, dur, n in host]
    return ev


def test_idle_share_is_the_union_of_intervals():
    # two overlapping kernels count once; a copy outside the stretch
    # does not count; a 50 us stall between
    raw = _raw([(0.0, 20.0, "void se_fwd<__nv_bfloat16>(int)"), (10.0, 20.0, "k"),
                (80.0, 10.0, "gemm")],
               host=[(40.0, 5.0, "cudaStreamSynchronize"),
                     (79.0, 1.0, "cudaLaunchKernel")])
    t = trace.from_events(raw, units=2)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.category_us()["port se_fwd"] == 20.0
    gaps = t.idle_gaps()
    assert gaps[0] == ["before cudaStreamSynchronize", pytest.approx(50e-6)]
    assert gaps[1][1] == pytest.approx(10e-6)
    assert [g[0] for g in gaps] == ["before cudaStreamSynchronize",
                                   "host: no call"]


def test_union_and_gaps():
    assert trace.union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]
    assert trace.gaps([(0, 3), (5, 9)], -1, 12) == [(-1, 0), (3, 5),
                                                    (9, 12)]


def test_nearest_rank_p95_sees_a_stall():
    spans = [10.0] * 95 + [500.0] * 5
    assert clock.nearest_rank(spans, 95) == 10.0
    assert clock.nearest_rank(spans + [500.0], 95) == 500.0
    assert clock.nearest_rank([3.0, 1.0, 2.0], 95) == 3.0
    assert clock.nearest_rank(list(range(1, 21)), 95) == 19
