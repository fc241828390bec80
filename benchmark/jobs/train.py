"""Train steps of `ecgmm_torch`, back to back.

Set-up builds the configuration's model and task through the trainer's
own `workloads/run.build_model_and_task`, fills the weights from the
seed, builds one train state (`train/state.create_state`) and a pool of
`pool` rows on the card. Every step takes `batch` distinct rows of the
pool through `engine.gather_batch` and `engine.train_step`, a new
permutation on each pass over the pool. Set-up drives that same state
through two checks of CHECK_STEPS steps each, which the reference
follows once the window has closed: `first`, the first steps from the
seed, and `warm`, the steps after WARMUP_STEPS more, just before the
window, from a snapshot of the state (parameters, BatchNorm statistics,
Adam's moments and update count, the dropout generator). The window
follows the warm check; with tracing, a stretch of `stretch_steps` steps
follows the window.

Float32 work runs in float32 (TF32 off), as the trainer's CLI runs it."""

from __future__ import annotations

import gc
import time

import torch

from benchmark.harness import clock, inputs, judge, spec, work
from benchmark.harness.execute import Run
from benchmark.harness.trace import profile
from benchmark.reference import arith as ref_arith
from benchmark.reference import models as ref_models
from benchmark.reference import optim as ref_optim

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BETA1 = 0.9
CHECKS = ("first", "warm")
CHECK_STEPS = 3     # the steps of each check
WARMUP_STEPS = 5    # the steps between the two checks


class Plan:
    """Batches of distinct pool rows: a fresh permutation of the pool on
    each pass, cut into full batches."""

    def __init__(self, n: int, batch: int, seed: int, device):
        if n < batch:
            raise spec.SpecError(f"a pool of {n} rows holds no batch of "
                                 f"{batch}")
        self.n, self.batch, self.device = n, batch, device
        self.g = inputs.generator(device, seed)
        self.batches = []

    def next(self) -> torch.Tensor:
        if not self.batches:
            perm = torch.randperm(self.n, generator=self.g,
                                  device=self.device)
            k = self.n // self.batch
            self.batches = list(perm[:k * self.batch].view(k, self.batch)
                                .unbind(0))
        return self.batches.pop(0)


def program_config(config: dict, batch: int, seed: int):
    """The port's preset with the run's dropout seed and batch, after a
    check that it is the configuration the file states."""
    import dataclasses

    from ecgmm_torch.config import get_preset

    cfg = get_preset(config["preset"])
    wanted = [("train", cfg.train, k, v) for k, v in config["train"].items()]
    wanted += [("model", cfg.model, k, config["model"][k])
               for k in config["preset_model_keys"]]
    for group, fields, key, value in wanted:
        if getattr(fields, key) != value:
            raise spec.SpecError(
                f"{config['name']}: the port's {config['preset']} has "
                f"{group}.{key} = {getattr(fields, key)!r}, the file "
                f"{value!r}")
    if cfg.data.signal_len != config["inputs"]["signal_len"]:
        raise spec.SpecError(f"{config['name']}: signal length differs")
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, seed=seed,
                                       batch_size=batch))


def frozen(config: dict, name: str) -> bool:
    return name.startswith(tuple(config.get("frozen_prefixes", ())))


def snapshot(model, state) -> dict:
    """The train state as the reference resumes it, copied to the host so
    that the card's peak stays the program's: every parameter and buffer,
    Adam's moments of the trained leaves by name, the update count and
    the dropout generator's state."""
    adam = state.optimizer.adam
    m, v = {}, {}
    for name, p in model.named_parameters():
        s = adam.state.get(p, {})
        if "exp_avg" in s:
            m[name] = s["exp_avg"].detach().to("cpu", copy=True)
            v[name] = s["exp_avg_sq"].detach().to("cpu", copy=True)
    return {"weights": {k: t.detach().to("cpu", copy=True)
                        for k, t in model.state_dict().items()},
            "m": m, "v": v, "count": state.step,
            "rng": state.generator.get_state()}


def first_gradient(model, state, config, m0: dict) -> dict:
    """Each trained leaf's gradient norm in the first step of a check, as
    Adam holds it after that step: (m - BETA1 m0) / (1 - BETA1), with m0
    the moment before it."""
    adam = state.optimizer.adam
    out = {}
    for name, p in model.named_parameters():
        if frozen(config, name):
            continue
        s = adam.state.get(p, {})
        if "exp_avg" not in s:
            out[name] = 0.0
            continue
        g = s["exp_avg"]
        if name in m0:
            g = g - BETA1 * m0[name].to(g.device)
        out[name] = float(g.norm()) / (1.0 - BETA1)
    return out


def readings(model, weights, config, grad1, losses):
    """Norms of the checked steps: {losses, grad, update, bn}."""
    update, bn = {}, {}
    for name, p in model.named_parameters():
        if not frozen(config, name):
            update[name] = float((p.detach() - weights[name].to(p.device))
                                 .norm())
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            bn[name] = float((b - weights[name].to(b.device)).norm())
    return {"losses": [float(x) for x in losses], "grad": grad1,
            "update": update, "bn": bn}


def reference_readings(config: dict, start: dict, batches, dropout_seed: int,
                       steps_per_epoch: int, device,
                       mode: str = "float32") -> dict:
    """The reference's readings of the same steps on the same rows, from
    `start` (weights; Adam's moments `m`, `v` and update count; the
    dropout generator's state `rng`, or None for a generator seeded with
    `dropout_seed`), in `mode` arithmetic (`reference/arith.py`)."""
    def on(d):
        return {k: t.to(device) for k, t in d.items()}

    weights = on(start["weights"])
    net = ref_models.build(config["reference"], config["model"], device)
    net.load_state_dict(weights)
    params = {n: p for n, p in net.named_parameters()
              if not frozen(config, n)}
    for n, p in net.named_parameters():
        p.requires_grad_(n in params)
    rng = inputs.generator(device, dropout_seed)
    if start["rng"] is not None:
        rng.set_state(start["rng"])
    rc = ref_models.RunCtx(ref_arith.Arith(mode), train=True, generator=rng,
                           mask_dtype=DTYPES[config["model"]["dtype"]])
    opt = ref_optim.Adam(params, ref_optim.schedule(config["train"],
                                                    steps_per_epoch),
                         m=on(start["m"]), v=on(start["v"]),
                         count=start["count"])
    t = config["train"]
    losses, grad1 = [], {}
    with ref_arith.exact_float32():
        for k, batch in enumerate(batches):
            if config["reference"] == "fusion":
                loss = net.loss(batch, rc, t["var_loss_weight"])
            else:
                loss = net.loss(batch, rc, t["focal_alpha"], t["focal_gamma"])
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            grads = dict(zip(params, grads))
            if k == 0:
                grad1 = {n: 0.0 if g is None else float(g.norm())
                         for n, g in grads.items()}
            opt.step(grads)
            losses.append(float(loss.detach()))
    return readings(net, weights, config, grad1, losses)


def compare(config: dict, prog, need: dict, mode: str = "float32"):
    """The compared numbers of both checks, `<check>.<number>`, and the
    readings behind them, {check: (side, reference)}: the program's
    readings `prog` against the float32 reference, or, with `prog` None,
    the reference in `mode` arithmetic in the program's place."""
    numbers, pairs = {}, {}
    for check in CHECKS:
        batches = [gather_rows(need["pool"], idx)
                   for idx in need[check]["rows"]]
        args = (config, need[check]["start"], batches, need["dropout_seed"],
                need["steps_per_epoch"], need["device"])
        ref = reference_readings(*args)
        side = prog[check] if prog else reference_readings(*args, mode=mode)
        numbers.update({f"{check}.{k}": v for k, v in
                        judge.train_numbers(side, ref).items()})
        pairs[check] = (side, ref)
    return numbers, pairs


def gather_rows(pool: dict, idx: torch.Tensor) -> dict:
    batch = {k: v.index_select(0, idx) for k, v in pool.items()}
    batch["mask"] = torch.ones(idx.shape[0], device=idx.device)
    return batch


def setup(ctx):
    """Build the state, the pool and the plan, and drive the two checks
    and the warm-up between them; returns (state, step function, the
    steps' losses, the program's readings of each check, what the
    reference needs: the pool, each check's start and rows)."""
    from ecgmm_torch.data.pipeline import Arrays
    from ecgmm_torch.precision import no_tf32
    from ecgmm_torch.train import engine
    from ecgmm_torch.train.state import create_state
    from ecgmm_torch.workloads.run import build_model_and_task

    cell, config, device = ctx.cell, ctx.config, ctx.device
    batch = cell["batch"]
    dropout_seed = inputs.subseed(ctx.seed, "dropout")
    cfg = program_config(config, batch, dropout_seed)
    clock.phase("imports", ctx.t_start)
    model, task, freeze = build_model_and_task(cfg, device)
    clock.phase("model", ctx.t_start)
    weights = inputs.make_weights(model, inputs.subseed(ctx.seed, "weights"))
    clock.sync(device)
    clock.phase("weights", ctx.t_start)
    steps_per_epoch = cell["pool"] // batch
    state = create_state(model, cfg.train, steps_per_epoch, freeze=freeze)
    pool = inputs.make_pool(config, cell["pool"],
                            inputs.subseed(ctx.seed, "pool"), device)
    arrays = Arrays(images=pool.get("images"), signals=pool["signals"],
                    clinical=pool.get("clinical"), labels=pool["labels"],
                    indices=None)
    plan = Plan(cell["pool"], batch, inputs.subseed(ctx.seed, "order"),
                device)
    mask = torch.ones(batch, device=device)
    losses = []
    clock.sync(device)
    clock.phase("state_and_pool", ctx.t_start)

    def step():
        idx = plan.next()
        with no_tf32():
            out = engine.train_step(task, state,
                                    engine.gather_batch(arrays, idx, mask))
        losses.append(out["loss"])
        return idx

    def check(start):
        n0, idxs = len(losses), []
        for k in range(CHECK_STEPS):
            idxs.append(step())
            if k == 0:
                grad1 = first_gradient(model, state, config, start["m"])
        prog = readings(model, start["weights"], config, grad1, losses[n0:])
        return prog, {"start": start, "rows": idxs}

    prog, need = {}, {"dropout_seed": dropout_seed, "pool": pool,
                      "steps_per_epoch": steps_per_epoch, "device": device}
    prog["first"], need["first"] = check(
        {"weights": weights, "m": {}, "v": {}, "count": 0, "rng": None})
    clock.phase("first_check", ctx.t_start)
    for _ in range(WARMUP_STEPS):
        step()
    prog["warm"], need["warm"] = check(snapshot(model, state))
    clock.phase("warm_check", ctx.t_start)
    return state, step, losses, prog, need


def run(ctx) -> Run:
    cell, config, device = ctx.cell, ctx.config, ctx.device
    state, step, losses, prog, need = setup(ctx)
    clock.sync(device)
    setup_s = time.perf_counter() - ctx.t_start
    n_before = len(losses)
    window = clock.measure(step, ctx.seconds, device)
    window_losses = losses[n_before:]
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    trace = None
    if ctx.trace:
        n = cell["stretch_steps"]

        def units():
            for _ in range(n):
                step()
            return n

        trace = profile(units, step, device, ctx.workdir)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del state, step, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, _ = compare(config, prog, need)
    rows = window.units * cell["batch"]
    return Run(
        job="train", cell=cell, config=config, window=window,
        end_to_end={
            "setup_s": (setup_s, "s"),
            "train_samples_per_s": (rows / window.wall_s, "samples/s"),
            "train_step_p95_ms": (clock.nearest_rank(window.spans_ms, 95),
                                  "ms"),
        },
        numbers=numbers,
        attempted=window.units, failed=failed, memory_peak_bytes=peak,
        flops_per_unit=work.train_step_flops(config, cell["batch"]),
        peak=config["peaks"]["train"], trace=trace)
