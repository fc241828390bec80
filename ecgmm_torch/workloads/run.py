"""Trainer CLI (port of `ecgmm_tpu/workloads/run.py`) for every preset
of the JAX package: the trimodal fusion presets, the image-only and
signal-only pretraining presets, the signal-only ResNet1D-SE presets, the
spectrogram CRNN and the 1-D Transformer:

    python -m ecgmm_torch.workloads.run                 # --preset fusion
    python -m ecgmm_torch.workloads.run --preset fusion_modal_balance
    python -m ecgmm_torch.workloads.run --preset fusion_cached
    python -m ecgmm_torch.workloads.run --preset fusion --cache-embeddings
    python -m ecgmm_torch.workloads.run --preset image_only
    python -m ecgmm_torch.workloads.run --preset ptbxl_af
    python -m ecgmm_torch.workloads.run --preset physionet_multi --epochs 3
    python -m ecgmm_torch.workloads.run --preset signal_12lead
    python -m ecgmm_torch.workloads.run --preset physionet_crnn
    python -m ecgmm_torch.workloads.run --preset physionet_transformer
    python -m ecgmm_torch.workloads.run --preset fusion --device cpu \
        --epochs 1 --n-synth 48

It trains on the card unless `--device cpu` is given, on the
deterministic synthetic cohort (as the JAX CLI does by default), and ends
with the reference's test protocol over the best and the last checkpoint
(train.py:174-336), with a temperature fit on the val split for each.
Float32 work runs in float32 on the card: the run turns TF32 off in cuDNN
and cuBLAS and restores the flags when it returns (`no_tf32`).
Checkpoints go to `--run-dir` (default `./checkpoints/<stamp>`), the
metric log to `./runs/<stamp>/metrics.jsonl` and the reports to
`./output/<stamp>/report_{best,last}.txt`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ecgmm_torch.config import Config, get_preset
from ecgmm_torch.data import pipeline, preprocess, splits, synthetic
from ecgmm_torch.models import (CRNN, ECGMultimodalModel, ECGTransformer1D,
                                ResNet18, ResNet1DSE)
from ecgmm_torch.models.crnn import lstm_bias_frozen
from ecgmm_torch.models.layers import flax_init_
from ecgmm_torch.train import calibrate, embed, engine
from ecgmm_torch.train.checkpoint import CheckpointManager
from ecgmm_torch.train.logging import MetricWriter
from ecgmm_torch.train.report import test_report
from ecgmm_torch.train.state import create_state, encoder_freeze_predicate
from ecgmm_torch.workloads.tasks import (make_fusion_task, make_image_task,
                                         make_signal_task,
                                         make_spectrogram_task)

FUSION_FAMILIES = ("fusion", "fusion_modal_balance", "fusion_cached")
# trained on the trimodal cohort, as in JAX (signal_only is not one of its
# SIGNAL_FAMILIES, ecgmm_tpu/workloads/run.py:224-242)
STAGE_PRESETS = ("image_only", "signal_only")
SIGNAL_FAMILIES = ("ptbxl_af", "physionet", "physionet_multi",
                   "physionet_crnn", "physionet_transformer", "signal_af",
                   "signal_arr", "signal_12lead")
REAL_DATA_ITEM = ("ROADMAP.md section 1, 'Real-data training': the PTB-XL "
                  "and PhysioNet records and their manifests are not in the "
                  "repository")


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; pass "
            "device='cpu' (--device cpu) to train on the CPU"
        )
    return device


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions and cuBLAS matmuls in float32, not TF32, while
    the context lasts; the flags are restored afterwards. Every float32
    op of the JAX package is float32 (the signal models, the image-only
    ResNet-18, the fusion head's float32 layers); bf16 work under
    autocast is unaffected."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def build_model_and_task(cfg: Config, device="cuda"):
    """The preset's model, initialised like flax's defaults from
    `cfg.train.seed`, on `device`, its task, and the predicate of the
    parameters its train state freezes (None: none)."""
    t = cfg.train
    if cfg.name in FUSION_FAMILIES:
        model = ECGMultimodalModel(cfg.model)
        task = make_fusion_task(t)
        freeze = encoder_freeze_predicate if t.freeze_encoders else None
    elif cfg.name == "image_only":
        model = ResNet18(num_classes=cfg.model.num_classes)
        task = make_image_task(t)
        freeze = None
    elif cfg.name == "physionet_crnn":
        model = CRNN(num_classes=cfg.model.num_classes)
        task = make_spectrogram_task(t)
        freeze = lstm_bias_frozen
    elif cfg.name == "physionet_transformer":
        model = ECGTransformer1D(num_classes=cfg.model.num_classes,
                                 seq_len=cfg.data.signal_len)
        task = make_signal_task(t)
        freeze = None
    elif cfg.name in SIGNAL_FAMILIES + ("signal_only",):
        model = ResNet1DSE(
            num_classes=cfg.model.num_classes,
            input_channels=cfg.model.signal_input_channels,
            base_filters=cfg.model.signal_base_filters,
            dropout=cfg.model.dropout,
        )
        task = make_signal_task(t)
        freeze = None
    else:
        raise ValueError(f"unknown preset {cfg.name!r}")
    flax_init_(model, torch.Generator().manual_seed(t.seed))
    return model.to(_device(device)), task, freeze


def load_data(cfg: Config, n_synth: int,
              device="cuda") -> pipeline.MaterializedData:
    """The preset's synthetic cohort, split and preprocessed as its
    reference trainer does, on `device`, with the JAX package's draws
    (`ecgmm_tpu/workloads/run.py:95-221`): the trimodal cohort of the
    fusion, image_only and signal_only presets (images img_height x
    img_width, the preset's clinical columns) through
    `materialize_trimodal`; PTB-XL is drawn at 500 Hz (2 x signal_len),
    split 60/20/20 and decimated, filtered and cut to signal_len;
    PhysioNet is split 80/10/10 (70/10/20 with three random classes for
    physionet_multi), band-passed and z-scored, and turned into
    log-spectrograms for physionet_crnn; the hospital presets take the
    hospital filter: signal_af a cohort of at least 60 with exactly 6
    random positives and the manual AF split, signal_12lead 12 leads of
    random gains, split 80/10/10 as signal_arr is."""
    seed = cfg.train.seed
    rng = np.random.default_rng(seed)
    if cfg.name in FUSION_FAMILIES + STAGE_PRESETS:
        c = synthetic.make_cohort(
            n=n_synth, signal_len=cfg.data.signal_len,
            img_hw=(cfg.data.img_height, cfg.data.img_width),
            n_clinical=cfg.model.clinical_in_features, seed=seed)
        return pipeline.materialize_trimodal(c, cfg, device=device)
    if cfg.name not in SIGNAL_FAMILIES:
        raise ValueError(f"unknown preset {cfg.name!r}")

    def cohort(n, signal_len=cfg.data.signal_len):
        return synthetic.make_cohort(n=n, signal_len=signal_len,
                                     img_hw=None, seed=seed)

    if cfg.name == "ptbxl_af":
        c = cohort(n_synth, 2 * cfg.data.signal_len)  # at 500 Hz
        return pipeline.materialize_signal(
            c.signals, c.labels, splits.stratified_622(c.labels, seed),
            preprocess_fn=lambda s: preprocess.preprocess_ptbxl(
                s, length=cfg.data.signal_len),
            device=device,
        )
    if cfg.name.startswith("physionet"):
        c = cohort(n_synth)
        labels = c.labels
        if cfg.model.num_classes > 2:
            labels = rng.integers(0, 3, len(labels))
            split = splits.stratified_712(labels, seed)
        else:
            split = splits.stratified_811(labels, seed)
        return pipeline.materialize_signal(
            c.signals, labels, split,
            preprocess_fn=preprocess.preprocess_physionet,
            spectrogram=(cfg.name == "physionet_crnn"), device=device,
        )
    if cfg.name == "signal_af":
        # exactly 6 AF positives (reference train_signal_only_af.py:93)
        c = cohort(max(n_synth, 60))
        labels = np.zeros(len(c.labels), np.int64)
        labels[rng.choice(len(labels), 6, replace=False)] = 1
        split = splits.manual_af_split(labels, seed)
        signals = c.signals
    elif cfg.name == "signal_12lead":
        c = cohort(n_synth)
        lead_gain = rng.uniform(0.5, 1.5, (1, 12, 1)).astype(np.float32)
        signals = c.signals[:, None, :] * lead_gain  # (N, 12, T)
        labels = c.labels
        split = splits.stratified_811(labels, seed)
    else:  # signal_arr
        c = cohort(n_synth)
        signals, labels = c.signals, c.labels
        split = splits.stratified_811(labels, seed)
    return pipeline.materialize_signal(
        signals, labels, split,
        preprocess_fn=preprocess.preprocess_hospital, device=device)


def ptbxl_sample_weights(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Inverse class frequency per train sample (reference
    train_signal_only_ptb.py:230-241)."""
    counts = np.bincount(labels, minlength=num_classes)
    return (1.0 / np.maximum(counts, 1))[labels]


def run(cfg: Config, data: pipeline.MaterializedData,
        run_dir: Optional[str] = None, verbose: bool = True,
        resume: bool = False, device="cuda"):
    """Train the preset on `data` (materialised on `device`), then run the
    best/last test protocol, with TF32 off (`no_tf32`). With
    `cache_embeddings` (the `fusion_cached` preset) the frozen encoders'
    BatchNorm statistics are first calibrated on the train split, each
    split is encoded once, and training and the test protocol run the
    fusion head task over the cached splits (`train/embed.py`). Returns
    (FitResult, {tag: metrics})."""
    with no_tf32():
        return _run(cfg, data, run_dir, verbose, resume, _device(device))


def _run(cfg, data, run_dir, verbose, resume, device):
    if data.train.labels.device.type != device.type:
        raise ValueError(f"data lies on {data.train.labels.device}, the run "
                         f"on {device}")
    t = cfg.train
    if resume and run_dir is None:
        raise ValueError("resume=True requires run_dir (the directory "
                         "holding the checkpoints to continue from)")
    stamp = (os.path.basename(os.path.normpath(run_dir)) if run_dir
             else time.strftime("%m%d_%H%M%S"))
    run_dir = run_dir or os.path.join(t.checkpoint_dir, stamp)

    model, task, freeze = build_model_and_task(cfg, device)
    state = create_state(model, t,
                         pipeline.num_batches(data.train.n, t.batch_size),
                         freeze=freeze)
    ckpt = CheckpointManager(run_dir, keep_epochs=t.keep_checkpoints)
    if resume and ckpt.exists("last"):
        ckpt.restore("last", state)
        if verbose:
            print(f"resumed from {run_dir} at epoch {state.epoch}")
    writer = MetricWriter(os.path.join(t.log_dir, stamp))
    try:
        data, head_task = embed.cache_run_splits(state, data, t,
                                                 frozen=t.freeze_encoders)
        task = head_task or task
        weights = None
        if cfg.name == "ptbxl_af":
            weights = ptbxl_sample_weights(data.train.labels.cpu().numpy(),
                                           cfg.model.num_classes)
        result = engine.fit(task, state, data.train, data.val, t, ckpt=ckpt,
                            writer=writer, verbose=verbose,
                            train_sample_weights=weights)

        # Test protocol: best then last; the temperature is fit on the val
        # split of each restored state and only reported against test.
        out_dir = os.path.join(t.output_dir, stamp)
        results, temperatures = {}, {}
        for tag in ("best", "last"):
            st = ckpt.restore(tag, result.state) if ckpt.exists(tag) \
                else result.state
            ev = engine.evaluate(task, st, data.test, t.eval_bs)
            results[tag] = test_report(ev.logits, ev.labels, out_dir, tag,
                                       threshold_search=(t.loss == "focal"))
            if data.val.n > 0:
                vev = engine.evaluate(task, st, data.val, t.eval_bs)
                temp = calibrate.fit_temperature(vev.logits, vev.labels)
                temperatures[tag] = temp
                results[tag].update(temperature=round(temp, 4))
                if len(ev.labels) > 0:
                    results[tag].update(
                        test_ece=round(calibrate.expected_calibration_error(
                            calibrate.calibrated_probs(ev.logits, 1.0),
                            ev.labels), 4),
                        test_ece_calibrated=round(
                            calibrate.expected_calibration_error(
                                calibrate.calibrated_probs(ev.logits, temp),
                                ev.labels), 4),
                    )
            if verbose:
                print(f"[{tag}] {results[tag]}")
        if temperatures:
            ckpt.save("calibration", {
                "temperature_best": float(temperatures.get("best", 1.0)),
                "temperature_last": float(temperatures.get("last", 1.0)),
            })
    finally:
        writer.close()
    return result, results


def apply_train_overrides(cfg: Config, epochs=None, batch_size=None,
                          lr=None, seed=None,
                          cache_embeddings=False) -> Config:
    overrides = {k: v for k, v in (("num_epochs", epochs),
                                   ("batch_size", batch_size), ("lr", lr),
                                   ("seed", seed)) if v is not None}
    if cache_embeddings:
        overrides["cache_embeddings"] = True
    if overrides:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **overrides))
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="fusion",
                   choices=FUSION_FAMILIES + STAGE_PRESETS + SIGNAL_FAMILIES)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None,
                   help="override the reference's fixed seed 42 (drives "
                        "the cohort, splits, init and sampling)")
    p.add_argument("--n-synth", type=int, default=128)
    p.add_argument("--cache-embeddings", action="store_true",
                   help="train a fusion preset's head over embeddings its "
                        "frozen encoders compute once per split")
    p.add_argument("--data-dir", default=None,
                   help="real PTB-XL/PhysioNet records: not ported yet")
    p.add_argument("--run-dir", default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue from --run-dir's last checkpoint")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    if args.data_dir is not None:
        raise FileNotFoundError(
            f"training on real records from {args.data_dir!r} waits for "
            f"{REAL_DATA_ITEM}; drop --data-dir to train on the synthetic "
            "cohort")
    cfg = apply_train_overrides(get_preset(args.preset), epochs=args.epochs,
                                batch_size=args.batch_size, lr=args.lr,
                                seed=args.seed,
                                cache_embeddings=args.cache_embeddings)
    device = _device(args.device)
    data = load_data(cfg, args.n_synth, device=device)
    run(cfg, data, run_dir=args.run_dir, resume=args.resume, device=device)


if __name__ == "__main__":
    main()
