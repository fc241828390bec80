"""The frozen reference agrees with `ecgmm_torch` at a small size on the
CPU: the same state dict loads into both, and the forward passes, losses,
gradients, BatchNorm statistics, dropout masks, Adam with its schedules
and the plain kernels give the same numbers. (The test
imports the port; the reference does not.)"""

import dataclasses

import pytest
import torch

from benchmark.harness import inputs, spec
from benchmark.reference import arith, kernels, models, optim

FUSION = spec.load_config("fusion")
TRANSFORMER = spec.load_config("physionet_transformer")


def _port_fusion(dtype="float32"):
    from ecgmm_torch.config import get_preset
    from ecgmm_torch.models import ECGMultimodalModel

    cfg = get_preset("fusion")
    return ECGMultimodalModel(dataclasses.replace(cfg.model, dtype=dtype))


def test_state_dicts_have_the_same_names_and_shapes():
    from ecgmm_torch.models import ECGTransformer1D

    for port, config in ((_port_fusion(), FUSION),
                         (ECGTransformer1D(num_classes=2, seq_len=3000),
                          TRANSFORMER)):
        ref = models.build(config["reference"], config["model"], "cpu")
        a = {k: tuple(v.shape) for k, v in port.state_dict().items()}
        b = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
        assert a == b


def test_fusion_train_forward_loss_and_statistics():
    from ecgmm_torch.data.pipeline import Batch
    from ecgmm_torch.models.layers import set_dropout_generator
    from ecgmm_torch.workloads.tasks import make_fusion_task
    from ecgmm_torch.config import TrainConfig

    port = _port_fusion()
    weights = inputs.make_weights(port, 11)
    ref = models.build("fusion", FUSION["model"], "cpu")
    ref.load_state_dict(weights)
    config = dict(FUSION, inputs=dict(FUSION["inputs"], image=[3, 64, 64]))
    pool = inputs.make_pool(config, 6, 12, "cpu")
    batch = Batch(images=pool["images"], signals=pool["signals"],
                  clinical=pool["clinical"], labels=pool["labels"],
                  mask=torch.ones(6))
    port.train()
    set_dropout_generator(port, torch.Generator().manual_seed(5))
    task = make_fusion_task(TrainConfig())
    loss, _ = task.loss(task.apply(port, batch), batch)
    rc = models.RunCtx(arith.Arith(), train=True,
                       generator=torch.Generator().manual_seed(5))
    want = ref.loss(dict(pool, mask=torch.ones(6)), rc, 0.1)
    assert float(loss.detach()) == pytest.approx(float(want.detach()),
                                                 rel=1e-5)
    rb = dict(ref.named_buffers())
    for name, buf in port.named_buffers():
        torch.testing.assert_close(buf, rb[name], rtol=1e-5, atol=1e-6)


def test_transformer_loss_and_gradients():
    from ecgmm_torch.models import ECGTransformer1D
    from ecgmm_torch.models.layers import set_dropout_generator
    from ecgmm_torch.train.losses import focal_loss

    t = 96
    port = ECGTransformer1D(num_classes=2, seq_len=t)
    weights = inputs.make_weights(port, 3)
    m = dict(TRANSFORMER["model"], seq_len=t)
    ref = models.build("transformer1d", m, "cpu")
    ref.load_state_dict(weights)
    x = torch.randn(3, t, generator=torch.Generator().manual_seed(4))
    y = torch.tensor([0, 1, 1])
    port.train()
    set_dropout_generator(port, torch.Generator().manual_seed(9))
    lp = focal_loss(port(x[:, None, :]), y, torch.ones(3))
    gp = torch.autograd.grad(lp, list(port.parameters()))
    rc = models.RunCtx(arith.Arith(), train=True,
                       generator=torch.Generator().manual_seed(9))
    lr = ref.loss({"signals": x, "labels": y, "mask": torch.ones(3)}, rc,
                  1.0, 2.0)
    gr = torch.autograd.grad(lr, list(ref.parameters()))
    assert float(lp.detach()) == pytest.approx(float(lr.detach()), rel=1e-5)
    for a, b in zip(gp, gr):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_plain_kernels_match_the_ports_plain_versions():
    from ecgmm_torch.ops import fusion, losses, se

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, 50, generator=g)
    w1, b1 = torch.randn(2, 32, generator=g), torch.randn(2, generator=g)
    w2, b2 = torch.randn(32, 2, generator=g), torch.randn(32, generator=g)
    torch.testing.assert_close(
        kernels.se_gate(x, w1, b1, w2, b2, arith.Arith()),
        se.reference_se(x, w1, b1, w2, b2))
    a, b, c = (torch.randn(5, d, generator=g) for d in (8, 4, 2))
    w, s, bias = (torch.randn(3, generator=g), torch.randn(14, generator=g),
                  torch.randn(14, generator=g))
    for got, want in zip(kernels.attention_fusion(a, b, c, w, s, bias, 1e-5),
                         fusion.reference_attention_fusion(a, b, c, w, s,
                                                           bias, 1e-5)):
        torch.testing.assert_close(got, want)
    logits = torch.randn(6, 3, generator=g)
    labels = torch.tensor([0, 2, 1, 1, 0, 2])
    mask = torch.tensor([1.0, 1, 0, 1, 1, 0])
    torch.testing.assert_close(
        kernels.focal_loss(logits, labels, mask, 1.0, 2.0),
        losses.reference_focal(logits, labels, mask, 1.0, 2.0))


@pytest.mark.parametrize("preset", ["fusion", "physionet_transformer"])
def test_adam_and_its_schedule(preset):
    from ecgmm_torch.config import get_preset
    from ecgmm_torch.train.optim import Optimizer

    cfg = get_preset(preset)
    config = spec.load_config(preset)
    g = torch.Generator().manual_seed(1)
    p0 = torch.randn(10, generator=g)
    grads = [torch.randn(10, generator=g) * 10 ** -k for k in range(4)]
    port = torch.nn.Parameter(p0.clone())
    opt = Optimizer([port], cfg.train, steps_per_epoch=7)
    ref = {"p": p0.clone()}
    ropt = optim.Adam(ref, optim.schedule(config["train"], 7))
    for k, gk in enumerate(grads):
        port.grad = gk.clone()
        opt.step(k)
        ropt.step({"p": gk})
    torch.testing.assert_close(port.detach(), ref["p"], rtol=1e-6, atol=1e-8)



@pytest.mark.parametrize("mode, bits", [("tf32", 10), ("bf16", 7),
                                        ("fp8", 3)])
def test_lower_arithmetic_rounds_operands_and_passes_gradients(mode, bits):
    """Each lower arithmetic keeps `bits` mantissa bits of an operand (fp8
    after its per-tensor scale, above e4m3's least normal number) and
    passes the gradient straight through."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float32).requires_grad_()
    q = arith.Arith(mode).q(x)
    scale = arith.FP8_MAX / x.detach().abs().max() if mode == "fp8" else 1.0
    normal = (x.detach() * scale).abs() >= 2.0 ** -6
    y = (q.detach() * scale).abs()[normal]
    kept = y / torch.exp2(torch.floor(torch.log2(y)) - bits)
    assert torch.equal(kept, kept.round())       # no bit below `bits`
    rel = ((q - x).abs() / x.abs()).detach()[normal].max()
    assert 0 < rel <= 2.0 ** -(bits + 1) * (1 + 1e-6)
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
