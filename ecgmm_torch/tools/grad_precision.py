"""Read float32 gradients of the full-width ptbxl_af model against float64,
for the whole first train step and op by op, under several backend
settings.

    python -m ecgmm_torch.tools.grad_precision [--device cuda]

The first weighted-sampling batch of `ptbxl_af` (64 synthetic records,
dropout 0, flax-style init from the preset's seed) goes forward and
backward in float64 on the CPU, with the preset's focal loss taken in
float64; every Conv1d, BatchNorm1d, SE block and Linear records its input
and the gradient of its output. Then, under each backend setting
(`SETTINGS`, applied on `--device`) and once on the CPU in float32:

  * step: the float32 gradient of every parameter;
  * op: each recorded op's backward in float32 (input and parameter
    gradients), fed the float64 run's input and output gradient;

each tensor read as max|g - g64| / max|g64|. One line per setting gives
the worst tensor of the step and the forward's discrete choices (the sign
of each ReLU's input, the max-pool's argmax) that differ from float64;
one line per op and setting gives that op's worst gradient. Convolution
biases are left out: every convolution feeds a BatchNorm, so their exact
gradient is zero. chip_smoke.py phase 6a reads the card's first step
with the same helpers.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ecgmm_torch.config import get_preset
from ecgmm_torch.models.layers import BatchNorm1d
from ecgmm_torch.models.resnet1d_se import BasicBlock1D, SEBlock1D
from ecgmm_torch.train import engine
from ecgmm_torch.workloads import run as train_run

# backend flags per setting; unnamed flags are False, `cudnn` True
SETTINGS = {
    "default": {},
    "deterministic": {"deterministic": True},
    "benchmark": {"benchmark": True},
    "no_cudnn": {"cudnn": False},
    "tf32": {"tf32": True, "matmul_tf32": True},
    "no_cudnn_tf32": {"cudnn": False, "matmul_tf32": True},
}
OPS = (nn.Conv1d, BatchNorm1d, SEBlock1D, nn.Linear)


def apply_setting(name: str):
    """Set the backend flags of `name`; returns the previous flags."""
    s = SETTINGS[name]
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
           cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.enabled = s.get("cudnn", True)
    cudnn.benchmark = s.get("benchmark", False)
    cudnn.deterministic = s.get("deterministic", False)
    cudnn.allow_tf32 = s.get("tf32", False)
    matmul.allow_tf32 = s.get("matmul_tf32", False)
    return old


def restore_setting(old) -> None:
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
     matmul.allow_tf32) = old


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest component of b."""
    return ((a.double().cpu() - b.double().cpu()).abs().max()
            / b.double().cpu().abs().max().clamp_min(1e-30)).item()


def batch_plan(n_synth: int = 64):
    """The ptbxl_af preset with dropout 0, its train split on the CPU, the
    first epoch's weighted-sampling plan (indices, mask), and the model
    (on the CPU) with its task."""
    cfg = get_preset("ptbxl_af")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             dropout=0.0))
    t = cfg.train
    train = train_run.load_data(cfg, "synthetic", n_synth, device="cpu").train
    weights = train_run.ptbxl_sample_weights(train.labels.numpy(),
                                             cfg.model.num_classes)
    idx, mask = engine.epoch_indices(train.n, t.batch_size, shuffle=True,
                                     seed=t.seed, epoch=0,
                                     sample_weights=weights)
    model, task, _ = train_run.build_model_and_task(cfg, "cpu")
    return cfg, train, idx, mask, model, task


def plan_batch(train, idx, mask, i: int):
    """Batch i of the plan, gathered on the CPU."""
    return engine.gather_batch(train,
                               torch.from_numpy(idx[i].astype(np.int64)),
                               torch.from_numpy(mask[i]))


def conv_biases(model) -> set:
    return {f"{n}.bias" for n, m in model.named_modules()
            if isinstance(m, nn.Conv1d)}


def focal64(logits, labels, mask):
    """The preset's focal loss (alpha 1, gamma 2) in float64."""
    out = logits.double()
    ce = torch.logsumexp(out, -1) - out.gather(-1, labels[:, None])[:, 0]
    mk = mask.double()
    return ((1 - torch.exp(-ce)) ** 2 * ce * mk).sum() / mk.sum().clamp_min(1)


def grads64(model, batch, record: bool = False):
    """The step's float64 gradients on the CPU (the model returns float32
    logits, as the JAX module does; the loss is taken after casting them
    back). With `record`, also each op's float64 input and output
    gradient, by module name."""
    m = copy.deepcopy(model).double().train()
    seen, hooks = {}, []

    def hook(name):
        def fwd(mod, inp, out):
            seen[name] = [inp[0].detach(), None]
            out.register_hook(lambda g: seen[name].__setitem__(1, g))
        return fwd

    if record:
        hooks = [mod.register_forward_hook(hook(n))
                 for n, mod in m.named_modules() if isinstance(mod, OPS)]
    out = m(batch.signals.double().unsqueeze(1))
    focal64(out, batch.labels, batch.mask).backward()
    for h in hooks:
        h.remove()
    return {k: p.grad for k, p in m.named_parameters()}, seen


def step_grads32(model, batch, task, device):
    """The step's float32 gradients on `device`, through the port's ops."""
    m = copy.deepcopy(model).to(device).train()
    b = batch._replace(signals=batch.signals.to(device),
                       labels=batch.labels.to(device),
                       mask=batch.mask.to(device))
    loss, _ = task.loss(task.apply(m, b), b)
    loss.backward()
    return {k: p.grad.cpu() for k, p in m.named_parameters()
            if p.grad is not None}


def op_grads(mod, x, g, device, dtype):
    """Gradients of one op w.r.t. its input and parameters in `dtype` on
    `device`, for the input x and output gradient g."""
    m = copy.deepcopy(mod).to(device, dtype).train()
    leaf = x.to(device, dtype).requires_grad_(True)
    params = [p for _, p in m.named_parameters()]
    out = m(leaf)
    grads = torch.autograd.grad(out, [leaf] + params, g.to(device, dtype))
    names = ["input"] + [n for n, _ in m.named_parameters()]
    return dict(zip(names, grads))


def decisions(model, batch, device, dtype):
    """The forward's discrete choices by module: the sign of each ReLU's
    input (the first BatchNorm of a block, the stem's, the head's first
    Linear; a block's output is its ReLU's) and the max-pool's argmax
    with the maximum."""
    m = copy.deepcopy(model).to(device, dtype).train()
    seen, hooks = {}, []
    for name, mod in m.named_modules():
        if isinstance(mod, nn.MaxPool1d):
            def fwd(mod, inp, out, name=name):
                val, idx = F.max_pool1d(inp[0], mod.kernel_size, mod.stride,
                                        mod.padding, return_indices=True)
                seen[name] = (idx.cpu(), val.cpu())
        elif (name in ("initial.1", "classifier.1") or name.endswith("bn1")
              or isinstance(mod, BasicBlock1D)):
            def fwd(mod, inp, out, name=name):
                seen[name] = (out > 0).cpu()
        else:
            continue
        hooks.append(mod.register_forward_hook(fwd))
    with torch.no_grad():
        m(batch.signals.to(device, dtype).unsqueeze(1))
    for h in hooks:
        h.remove()
    return seen


def flips(got, want):
    """Choices of `got` that differ from `want`, by module, with their
    channels; an argmax counts only where the maximum is positive (a tie
    among ReLU zeros routes no gradient)."""
    out = {}
    for name, w in want.items():
        if isinstance(w, tuple):
            diff = (got[name][0] != w[0]) & (w[1] > 0)
        else:
            diff = got[name] != w
        if diff.any():
            out[name] = (int(diff.sum()),
                         sorted(set(diff.nonzero()[:, 1].tolist())))
    return out


def worst(got, want, skip=()):
    return max((rel(got[k], want[k]), k) for k in want if k not in skip)


def worst_channel(got, want, key) -> int:
    """The output channel (first index) of tensor `key`'s largest
    error."""
    diff = (got[key].double().cpu() - want[key].double().cpu()).abs()
    return int(np.unravel_index(int(diff.argmax()), diff.shape)[0])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    device = torch.device(p.parse_args(argv).device)
    _, train, idx, mask, model, task = batch_plan()
    batch = plan_batch(train, idx, mask, 0)
    skip_biases = conv_biases(model)
    g64, seen = grads64(model, batch, record=True)
    modules = dict(model.named_modules())

    d64 = decisions(model, batch, "cpu", torch.float64)
    cpu = step_grads32(model, batch, task, "cpu")
    cpu_flips = flips(decisions(model, batch, "cpu", torch.float32), d64)
    print(f"step cpu float32: worst {worst(cpu, g64, skip_biases)}; "
          f"choices off float64 {cpu_flips}", flush=True)
    for name in SETTINGS:
        old = apply_setting(name)
        try:
            got = step_grads32(model, batch, task, device)
            dev_flips = flips(decisions(model, batch, device, torch.float32),
                              d64)
        finally:
            restore_setting(old)
        err, key = worst(got, g64, skip_biases)
        print(f"step {device.type} {name}: worst ({err}, {key!r}, channel "
              f"{worst_channel(got, g64, key)}); choices off float64 "
              f"{dev_flips}", flush=True)

    for op, (x, g) in seen.items():
        mod = modules[op]
        want = op_grads(mod, x, g, "cpu", torch.float64)
        skip = {"bias"} if isinstance(mod, nn.Conv1d) else set()
        cpu32 = op_grads(mod, x, g, "cpu", torch.float32)
        line = [f"cpu {worst(cpu32, want, skip)[0]:.3g}"]
        for name in SETTINGS:
            old = apply_setting(name)
            try:
                got = op_grads(mod, x, g, device, torch.float32)
            finally:
                restore_setting(old)
            err, which = worst(got, want, skip)
            line.append(f"{name} {err:.3g} ({which})")
        print(f"op {op} {type(mod).__name__} in {tuple(x.shape)}: "
              + "; ".join(line), flush=True)


if __name__ == "__main__":
    main()
