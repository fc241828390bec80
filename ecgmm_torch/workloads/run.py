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
deterministic synthetic cohort (as the JAX CLI does by default) or on
records read from a directory, and ends with the reference's test
protocol over the best and the last checkpoint (train.py:174-336), with a
temperature fit on the val split for each:

    python -m ecgmm_torch.workloads.run --preset fusion --data hospital \
        --data-dir ./data                 # labels.xlsx, clinical.csv, ...
    python -m ecgmm_torch.workloads.run --preset ptbxl_af --data-dir ./ptbxl
    python -m ecgmm_torch.workloads.run --preset physionet_multi \
        --data-dir ./physionet            # REFERENCE.csv, training2017/

An explicit `--data-dir` means real data: it sets the hospital, PTB-XL and
PhysioNet directories alike. `--split-cache DIR` saves the materialised
splits there on the first run and reopens them memory-mapped on later
ones (a cache built for another preset, source, directory, cohort size,
seed or geometry is refused). A split over the device-memory budget
(`ECGMM_HBM_BUDGET_BYTES`, else 60% of the card's memory) stays on the
host and streams, in chunks of `ECGMM_STREAM_CHUNK_BATCHES` batches (else
`pipeline.auto_chunk_batches`).
Float32 work runs in float32 on the card: the run turns TF32 off in cuDNN
and cuBLAS and restores the flags when it returns (`no_tf32`).
Checkpoints go to `--run-dir` (default `./checkpoints/<stamp>`), the
metric log to `./runs/<stamp>/metrics.jsonl` and the reports to
`./output/<stamp>/`: `report_{best,last}.txt`, `confusion_{best,last}.png`
and, for two classes, `roc_{best,last}.png`.

Under torchrun the run spreads over the ranks, one card each, over NCCL
(`parallel/mesh.init_distributed`): `n_data = world / n_model`, and
`--n-model k` trains tensor-parallel over a (data, model) mesh:

    torchrun --standalone --nproc-per-node 8 -m ecgmm_torch.workloads.run \
        --preset fusion [--n-model 2]

Every rank computes what one process computes on the same global batch
(`train/engine.py`); rank 0 alone writes the checkpoints, the metric log
and the reports. With `--device cpu` the ranks join over gloo.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ecgmm_torch.config import Config, get_preset
from ecgmm_torch.data import (align, pipeline, preprocess, sources, splits,
                              synthetic)
from ecgmm_torch.models import (CRNN, ECGMultimodalModel, ECGTransformer1D,
                                ResNet18, ResNet1DSE)
from ecgmm_torch.models.crnn import lstm_bias_frozen
from ecgmm_torch.models.layers import flax_init_
from ecgmm_torch.parallel import collectives
from ecgmm_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from ecgmm_torch.precision import no_tf32
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


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; pass "
            "device='cpu' (--device cpu) to train on the CPU"
        )
    return device


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


def load_data(cfg: Config, source: str = "synthetic", n_synth: int = 128,
              device="cuda") -> pipeline.MaterializedData:
    """The preset's data, split and preprocessed as its reference trainer
    does (`ecgmm_tpu/workloads/run.py:95-281`), on `device` as far as the
    device-memory budget allows (`device=None`: every split on the host,
    for the split cache).

    `source` "synthetic" draws the JAX package's synthetic cohort:
    `n_synth` trimodal records for the fusion, image_only and signal_only
    presets (images img_height x img_width, the preset's clinical
    columns); PTB-XL at 500 Hz (2 x signal_len); PhysioNet (three random
    classes for physionet_multi); for signal_af a cohort of at least 60
    with exactly 6 random positives, for signal_12lead 12 leads of random
    gains.

    Any other source reads records: "hospital" the directory
    `cfg.data.data_dir` (`_hospital_cohort`) for the trimodal presets; the
    PTB-XL presets read `cfg.data.ptbxl_dir` (`ptbxl_database.csv`, lead II
    of each `filename_hr` record), the PhysioNet presets
    `cfg.data.physionet_dir` (`REFERENCE.csv`, the first channel of each
    record under `training2017/`, right-padded with zeros or cut to
    signal_len); a missing manifest raises FileNotFoundError. The hospital
    signal presets (signal_af, signal_arr, signal_12lead) read no records
    in either package.

    The splits and filters: trimodal 8:1:1 through `materialize_trimodal`;
    PTB-XL 60/20/20, decimated, filtered and cut to signal_len; PhysioNet
    80/10/10 (70/10/20 for three classes), band-passed and z-scored,
    log-spectrograms for physionet_crnn; the hospital presets the hospital
    filter, signal_af the manual AF split."""
    if not isinstance(source, str):
        raise TypeError(f"source must be 'synthetic' or a record source, "
                        f"got {source!r}")
    seed = cfg.train.seed
    rng = np.random.default_rng(seed)
    if cfg.name in FUSION_FAMILIES + STAGE_PRESETS:
        if source == "synthetic":
            c = synthetic.make_cohort(
                n=n_synth, signal_len=cfg.data.signal_len,
                img_hw=(cfg.data.img_height, cfg.data.img_width),
                n_clinical=cfg.model.clinical_in_features, seed=seed)
        elif source == "hospital":
            c = _hospital_cohort(cfg)
        else:
            raise ValueError(f"unknown data source {source!r}")
        return pipeline.materialize_trimodal(c, cfg, device=device)
    if cfg.name not in SIGNAL_FAMILIES:
        raise ValueError(f"unknown preset {cfg.name!r}")

    def cohort(n, signal_len=cfg.data.signal_len):
        return synthetic.make_cohort(n=n, signal_len=signal_len,
                                     img_hw=None, seed=seed)

    if cfg.name == "ptbxl_af":
        if source != "synthetic":
            mani = _manifest(cfg.data.ptbxl_dir, "ptbxl_database.csv",
                             "PTB-XL", sources.load_ptbxl_manifest)
            signals = np.stack([sources.read_wfdb(r, channels=[1])[0][:, 0]
                                for r in mani["record"]])
            labels = mani["label"]
        else:
            c = cohort(n_synth, 2 * cfg.data.signal_len)  # at 500 Hz
            signals, labels = c.signals, c.labels
        return pipeline.materialize_signal(
            signals, labels, splits.stratified_622(labels, seed),
            preprocess_fn=lambda s: preprocess.preprocess_ptbxl(
                s, length=cfg.data.signal_len),
            device=device,
        )
    if cfg.name.startswith("physionet"):
        multiclass = cfg.model.num_classes > 2
        if source != "synthetic":
            mani = _manifest(
                cfg.data.physionet_dir, "REFERENCE.csv", "PhysioNet",
                lambda d: sources.load_physionet_manifest(
                    d, multiclass=multiclass))
            signals = np.stack([
                preprocess.pad_or_crop(
                    sources.read_wfdb(r)[0][:, 0].astype(np.float32),
                    cfg.data.signal_len)
                for r in mani["record"]])
            labels = mani["label"]
        else:
            c = cohort(n_synth)
            signals, labels = c.signals, c.labels
            if multiclass:
                labels = rng.integers(0, 3, len(labels))
        split = (splits.stratified_712(labels, seed) if multiclass
                 else splits.stratified_811(labels, seed))
        return pipeline.materialize_signal(
            signals, labels, split,
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


def _manifest(directory: str, name: str, what: str, read):
    path = os.path.join(directory, name)
    if not os.path.exists(path):
        # an explicit real-data request must not train on the synthetic
        # cohort instead
        raise FileNotFoundError(
            f"real {what} requested but {path} not found — point --data-dir "
            "at the download or drop --data")
    return read(directory)


def _hospital_cohort(cfg: Config) -> synthetic.SyntheticCohort:
    """A hospital directory as a cohort (`ecgmm_tpu/workloads/run.py:
    243-281`, reference dataset.py:118-162): the labels mapped
    Normal/Abnormal -> 0/1 (Borderline dropped), the patients in every
    table and with an image folder (less `known_missing`), in the label
    table's order; each patient's image decoded and resized to
    img_height x img_width; the clinical columns other than `index`, in
    the file's order."""
    d = cfg.data
    labels, clinical, ecg = sources.load_hospital_tables(
        os.path.join(d.data_dir, d.label_file),
        os.path.join(d.data_dir, d.clinical_file),
        os.path.join(d.data_dir, d.ecg_csv))
    labels = align.filter_and_map_labels(labels)
    common = align.intersect_indices(
        labels["index"], ecg.index, clinical["index"],
        sources.list_image_indices(d.image_dir), d.known_missing)
    labels, ecg, clinical = align.align_frames(labels, ecg, clinical, common)
    order = labels["index"]
    clin_cols = [c for c in clinical.columns if c != "index"]
    return synthetic.SyntheticCohort(
        indices=order,
        labels=labels["label"],
        signals=ecg.loc(order).to_numpy(np.float32),
        clinical=clinical.set_index("index").loc(order).select(clin_cols)
        .to_numpy(np.float32),
        images=sources.load_images(d.image_dir, order.tolist(),
                                   hw=(d.img_height, d.img_width)),
        clinical_columns=tuple(clin_cols),
    )


def ptbxl_sample_weights(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Inverse class frequency per train sample (reference
    train_signal_only_ptb.py:230-241)."""
    counts = np.bincount(labels, minlength=num_classes)
    return (1.0 / np.maximum(counts, 1))[labels]


def run(cfg: Config, data: pipeline.MaterializedData,
        run_dir: Optional[str] = None, verbose: bool = True,
        resume: bool = False, device="cuda", mesh: Optional[Mesh] = None):
    """Train the preset on `data` (materialised for `device`), then run the
    best/last test protocol, with TF32 off (`no_tf32`). Splits over the
    device-memory budget (`pipeline.resolve_hbm_budget`) stay on the host
    and stream, the test split too; the first of them sets the chunk size
    when `stream_chunk_batches` is 0 (`ECGMM_STREAM_CHUNK_BATCHES`, else
    `pipeline.auto_chunk_batches`). With `cache_embeddings` (the
    `fusion_cached` preset) the frozen encoders' BatchNorm statistics are
    first calibrated on the train split, each split is encoded once, and
    training and the test protocol run the fusion head task over the
    cached splits (`train/embed.py`). With `mesh` every rank of it calls
    run on the same data; rank 0 writes. Returns (FitResult, {tag:
    metrics})."""
    with no_tf32():
        return _run(cfg, data, run_dir, verbose, resume, _device(device),
                    mesh)


def _labels_np(arrays) -> np.ndarray:
    labels = arrays.labels
    return labels.cpu().numpy() if isinstance(labels, torch.Tensor) \
        else np.asarray(labels)


def _shared_stamp(mesh: Optional[Mesh]) -> str:
    """The run's time stamp, rank 0's on every rank."""
    stamp = time.strftime("%m%d_%H%M%S")
    if mesh is None or mesh.size == 1:
        return stamp
    import torch.distributed as dist

    return collectives.all_gather_objects(stamp, dist.group.WORLD)[0]


def _run(cfg, data, run_dir, verbose, resume, device, mesh=None):
    writes = mesh is None or mesh.is_writer
    verbose = verbose and writes
    for name in ("train", "val", "test"):
        labels = getattr(data, name).labels
        if isinstance(labels, torch.Tensor) and \
                labels.device.type != device.type:
            raise ValueError(f"data lies on {labels.device}, the run on "
                             f"{device}")
    t = cfg.train
    if resume and run_dir is None:
        raise ValueError("resume=True requires run_dir (the directory "
                         "holding the checkpoints to continue from)")
    stamp = (os.path.basename(os.path.normpath(run_dir)) if run_dir
             else _shared_stamp(mesh))
    run_dir = run_dir or os.path.join(t.checkpoint_dir, stamp)

    model, task, freeze = build_model_and_task(cfg, device)
    state = create_state(model, t,
                         pipeline.num_batches(data.train.n, t.batch_size),
                         freeze=freeze)
    ckpt = CheckpointManager(run_dir, keep_epochs=t.keep_checkpoints,
                             writer=writes)
    from ecgmm_torch.parallel import tp

    tp.place_state(state, mesh)
    if resume and ckpt.exists("last"):
        ckpt.restore("last", state)
        if verbose:
            print(f"resumed from {run_dir} at epoch {state.epoch}")
    writer = MetricWriter(os.path.join(t.log_dir, stamp)) if writes \
        else None
    try:
        budget = pipeline.resolve_hbm_budget(device)
        if budget:
            data = dataclasses.replace(data, **dict(zip(
                ("train", "val", "test"), pipeline.fit_splits_in_budget(
                    (data.train, data.val, data.test), budget, device))))
            if (t.stream_chunk_batches == 0
                    and isinstance(data.train, pipeline.HostArrays)):
                env_k = os.environ.get("ECGMM_STREAM_CHUNK_BATCHES")
                t = dataclasses.replace(t, stream_chunk_batches=int(
                    env_k or pipeline.auto_chunk_batches(
                        budget, data.train, t.batch_size, t.eval_bs)))
                if verbose and t.stream_chunk_batches > 1:
                    print(f"streaming in chunks of {t.stream_chunk_batches} "
                          "batches")
        data, head_task = embed.cache_run_splits(state, data, t,
                                                 frozen=t.freeze_encoders,
                                                 mesh=mesh)
        task = head_task or task
        weights = None
        if cfg.name == "ptbxl_af":
            weights = ptbxl_sample_weights(_labels_np(data.train),
                                           cfg.model.num_classes)
        result = engine.fit(task, state, data.train, data.val, t, ckpt=ckpt,
                            writer=writer, verbose=verbose,
                            train_sample_weights=weights, mesh=mesh)

        # Test protocol: best then last; the temperature is fit on the val
        # split of each restored state and only reported against test.
        out_dir = os.path.join(t.output_dir, stamp)
        results, temperatures = {}, {}
        for tag in ("best", "last"):
            st = ckpt.restore(tag, result.state) if ckpt.exists(tag) \
                else result.state
            ev = engine.evaluate(task, st, data.test, t.eval_bs,
                                 t.stream_chunk_batches, mesh=mesh)
            results[tag] = test_report(ev.logits, ev.labels,
                                       out_dir if writes else None, tag,
                                       threshold_search=(t.loss == "focal"))
            if data.val.n > 0:
                vev = engine.evaluate(task, st, data.val, t.eval_bs,
                                      t.stream_chunk_batches, mesh=mesh)
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
        if writer is not None:
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


def _barrier() -> None:
    """Wait for every rank of the run (none without a process group)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def split_fingerprint(args, cfg: Config) -> dict:
    """What shapes the materialised splits (the JAX CLI's fingerprint,
    `ecgmm_tpu/workloads/run.py:570-584`): saved beside a split cache and
    compared when it is reopened."""
    return {
        "preset": args.preset,
        "source": args.data,
        "data_dir": args.data_dir or "",
        "n_synth": args.n_synth,
        "seed": cfg.train.seed,
        "variant": cfg.model.variant,
        "signal_len": cfg.data.signal_len,
        "img_hw": [cfg.data.img_height, cfg.data.img_width],
        "clinical_in": cfg.model.clinical_in_features,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="fusion",
                   choices=FUSION_FAMILIES + STAGE_PRESETS + SIGNAL_FAMILIES)
    p.add_argument("--data", default="synthetic",
                   choices=["synthetic", "hospital"])
    p.add_argument("--data-dir", default=None,
                   help="the records: a hospital directory, or the PTB-XL "
                        "or PhysioNet download (implies real data)")
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
    p.add_argument("--split-cache", default=None, metavar="DIR",
                   help="save the materialised splits here on the first "
                        "run and reopen them memory-mapped on later ones "
                        "(splits over the device budget stream from disk)")
    p.add_argument("--run-dir", default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue from --run-dir's last checkpoint")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--n-model", type=int, default=None,
                   help="model-axis size: >1 trains tensor-parallel "
                        "(column-sharded weights, parallel/tp.py) over a "
                        "(data, model) mesh of the torchrun ranks")
    args = p.parse_args(argv)

    cfg = apply_train_overrides(get_preset(args.preset), epochs=args.epochs,
                                batch_size=args.batch_size, lr=args.lr,
                                seed=args.seed,
                                cache_embeddings=args.cache_embeddings)
    if args.data_dir:
        # one flag for wherever this preset's records live
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, data_dir=args.data_dir, ptbxl_dir=args.data_dir,
            physionet_dir=args.data_dir))
        if args.data == "synthetic":
            args.data = "hospital"  # an explicit --data-dir is real data
    if args.n_model is not None:
        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, n_model=args.n_model))
    device = _device(args.device)
    device = init_distributed(device=args.device) or device
    mesh = make_mesh(cfg.mesh, device)
    if not args.split_cache:
        data = load_data(cfg, args.data, args.n_synth, device=device)
    else:
        fingerprint = split_fingerprint(args, cfg)
        cached = pipeline.has_materialized(args.split_cache)
        _barrier()  # every rank has looked before the writer writes
        if not cached:
            # the splits stay on the host until saved; then every rank
            # reopens them through the memory-mapped path later runs take
            if mesh.is_writer:
                pipeline.save_materialized(
                    load_data(cfg, args.data, args.n_synth, device=None),
                    args.split_cache, meta=fingerprint)
                print(f"saved materialized splits to {args.split_cache}")
            _barrier()
        data = pipeline.load_materialized(
            args.split_cache, device=device,
            expect_meta=fingerprint if cached else None)
        if cached and mesh.is_writer:
            print(f"reopened materialized splits from {args.split_cache}")
    run(cfg, data, run_dir=args.run_dir, resume=args.resume, device=device,
        mesh=mesh)


if __name__ == "__main__":
    main()
