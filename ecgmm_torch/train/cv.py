"""Cross-validation harnesses (port of `ecgmm_tpu/train/cv.py`).

  * nested_cv: outer k_outer x inner k_inner stratified folds; for each
    inner fold the scalers are refit on its train rows, a fresh model
    trains through the full early-stop and plateau loop, and its best-val
    state is scored by AUC on the outer test fold; the outer AUC is the
    mean over the inner folds (reference train_kfold.py:135-178);
  * exhaustive_cv: every ordered (test, val) pair of one k-fold partition,
    k x (k - 1) fits (reference train_exhausted.py:165-217);
  * cross_dataset_eval: a trained signal model on another dataset with
    PTB-XL's preprocessing (reference evaluation_signal.py:20-39,171-219).

Both harnesses run the folds one after another by default, each through
`engine.fit(keep_best=True)`; `fold_parallel=True` trains them all at
once in the fold program of `train/cv_parallel.py` (the constant schedule
only). Fits run with TF32 off, as `workloads.run.run` does. A fit cut by
SIGTERM raises `engine.Preempted` and ends the harness: the AUCs of the
folds already finished are lost with it, as in the JAX package.

    python -m ecgmm_torch.train.cv nested --preset fusion [--device cpu]

Under torchrun every harness takes the ranks' mesh (`--n-model` as in
`workloads/run.py`): a sequential fit trains over all of them, and the
fold program spreads its folds over the data axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ecgmm_torch.config import Config
from ecgmm_torch.data import preprocess, splits
from ecgmm_torch.data.pipeline import (Arrays, HostArrays, num_batches,
                                       promote)
from ecgmm_torch.data.synthetic import SyntheticCohort
from ecgmm_torch.parallel import tp
from ecgmm_torch.parallel.mesh import init_distributed, make_mesh
from ecgmm_torch.precision import no_tf32
from ecgmm_torch.train import embed, engine
from ecgmm_torch.train import metrics as M
from ecgmm_torch.train.state import create_state


def _build_arrays(cohort: SyntheticCohort, idx: np.ndarray,
                  ecg_scaler: preprocess.Scaler,
                  clin_scaler: preprocess.Scaler, apply_filter: bool,
                  n_clin: int = 2, device="cuda") -> Arrays:
    """One fold's split on `device`: its signals scaled by the fold's
    scaler, then the hospital filter where `apply_filter`; the first
    `n_clin` clinical columns scaled; the images as they are."""
    sig = ecg_scaler.transform(cohort.signals[idx])
    if apply_filter:
        sig = preprocess.preprocess_hospital(sig)
    clin = clin_scaler.transform(cohort.clinical[idx, :n_clin])
    return promote(HostArrays(
        images=None if cohort.images is None else cohort.images[idx],
        signals=np.asarray(sig, np.float32),
        clinical=np.asarray(clin, np.float32),
        labels=np.asarray(cohort.labels[idx], np.int32),
        indices=cohort.indices[idx]), device)


def _softmax_auc(logits: np.ndarray, labels: np.ndarray) -> float:
    """AUC of the softmax's class-1 probability."""
    probs = torch.softmax(torch.from_numpy(np.asarray(logits, np.float32)),
                          dim=-1)[:, 1].numpy()
    return float(M.auroc(probs, labels))


def fit_fold(make_model_task: Callable, arrays: Dict[str, Arrays],
             cfg: Config, device="cuda", mesh=None
             ) -> Tuple[engine.FitResult, engine.EvalResult]:
    """One fold's fit on its (train, val, test) `arrays` and its test
    evaluation: a fresh model from `make_model_task`; where the cached
    path applies, the frozen encoders' BatchNorm statistics calibrated on
    this fold's train split and each split encoded once; `fit(keep_best=
    True)`; the test split scored on the best state, or the final one
    where no epoch improved; with `mesh`, over its ranks (JAX's
    `cv.py:59-140`). Returns (the fit, the test evaluation)."""
    t = cfg.train
    model, task, freeze = make_model_task(cfg, device)
    state = create_state(model, t, num_batches(arrays["train"].n,
                                               t.batch_size),
                         freeze=freeze)
    frozen = freeze is not None
    tp.place_state(state, mesh)
    embed.maybe_calibrate_bn_stats(state, arrays["train"], t, frozen=frozen,
                                   mesh=mesh)
    arrays, head_task = embed.maybe_cache_fusion_embeddings(
        state, arrays, t, frozen=frozen, mesh=mesh)
    task = head_task or task
    result = engine.fit(task, state, arrays["train"], arrays["val"], t,
                        verbose=False, keep_best=True, mesh=mesh)
    if result.best_state is not None:
        state.load_state_dict(result.best_state)
    return result, engine.evaluate(task, state, arrays["test"], t.eval_bs,
                                   mesh=mesh)


def _fold_auc(make_model_task: Callable, cohort: SyntheticCohort,
              split: splits.Split, cfg: Config, apply_filter: bool,
              device="cuda", mesh=None) -> float:
    """Train on (train, val), return the AUC of the best state on test:
    the reference's train_inner + test_outer (train_kfold.py:20-133). The
    scalers are refit on the fold's train rows; the clinical width
    follows the preset (`fit_fold` does the rest)."""
    n_clin = min(cfg.model.clinical_in_features, cohort.clinical.shape[1])
    ecg_scaler = preprocess.Scaler.fit(cohort.signals[split.train])
    clin_scaler = preprocess.Scaler.fit(cohort.clinical[split.train,
                                                        :n_clin])
    arrays = {name: _build_arrays(cohort, idx, ecg_scaler, clin_scaler,
                                  apply_filter, n_clin, device)
              for name, idx in zip(("train", "val", "test"), split)}
    result, ev = fit_fold(make_model_task, arrays, cfg, device, mesh)
    if result.preempted:
        # the fold trained short and the process is going down: neither
        # score it nor start the next fold
        raise engine.Preempted(
            "SIGTERM during a CV fold fit: stopping the harness")
    return _softmax_auc(ev.logits, ev.labels)


def _hint_fold_parallel(tcfg, n_folds: int, verbose: bool) -> None:
    """A pointer printed where the sequential harness runs folds that the
    fold program could take (the constant schedule). Sequential stays the
    default: it is the reference's protocol and takes every schedule."""
    if verbose and n_folds > 1 and tcfg.schedule == "constant":
        print(f"[cv] running {n_folds} folds sequentially; --fold-parallel "
              "trains them all at once on the card, each kernel one "
              "launch for every fold (train/cv_parallel.py)")


def _check_fold_parallel_schedule(tcfg) -> None:
    """Reject a schedule the fold program cannot run (per-fold step
    counts: onecycle) before any fold is prepared; `run_fold_parallel`
    checks again."""
    if tcfg.schedule != "constant":
        raise ValueError(
            "fold-parallel CV supports the constant+plateau schedule (the "
            f"reference CV protocol); got schedule={tcfg.schedule!r}. "
            "Schedules with per-fold step counts (onecycle) need the "
            "sequential harness.")


def _run_folds(make_model_task, cohort, fold_splits, cfg, apply_filter,
               verbose, device, mesh=None) -> List[float]:
    """Every fold's AUC through the fold program, in order."""
    from ecgmm_torch.train import cv_parallel

    _check_fold_parallel_schedule(cfg.train)
    task, state0, pack = cv_parallel.prepare_folds(
        make_model_task, cohort, fold_splits, cfg,
        apply_filter=apply_filter, device=device)
    return cv_parallel.run_fold_parallel(task, state0, pack, cfg.train,
                                         verbose=verbose, mesh=mesh).aucs


def nested_cv(make_model_task: Callable, cohort: SyntheticCohort,
              cfg: Config, apply_filter: bool = True, verbose: bool = True,
              fold_parallel: bool = False, device="cuda", mesh=None
              ) -> Dict[str, object]:
    """Outer k_outer x inner k_inner nested CV: each inner fold trains to
    early stop, its best-val state is scored on the outer test fold, and
    the outer AUC is the mean over the inner folds (the reference scores
    the last inner fold's checkpoint only; the mean is the JAX package's
    choice). `fold_parallel` trains all k_outer x k_inner folds in one
    fold program (`train/cv_parallel.py`), its folds spread over the data
    axis of `mesh`; without fold_parallel every fit runs over the mesh's
    ranks."""
    t = cfg.train
    groups = list(splits.nested_kfold(cohort.labels, t.k_outer, t.k_inner,
                                      t.seed))
    with no_tf32():
        if fold_parallel:
            flat = [s for _, _, inner in groups for s in inner]
            aucs = iter(_run_folds(make_model_task, cohort, flat, cfg,
                                   apply_filter, verbose, device, mesh))
            per_outer = [[next(aucs) for _ in inner]
                         for _, _, inner in groups]
        else:
            _hint_fold_parallel(t, sum(len(i) for _, _, i in groups),
                                verbose)
            per_outer = [[_fold_auc(make_model_task, cohort, s, cfg,
                                    apply_filter, device, mesh)
                          for s in inner]
                         for _, _, inner in groups]
    outer_aucs = []
    for (fold_id, _, _), fold_aucs in zip(groups, per_outer):
        auc = float(np.nanmean(fold_aucs))
        outer_aucs.append(auc)
        if verbose:
            print(f"[outer {fold_id}] inner AUCs={fold_aucs} "
                  f"mean={auc:.4f}")
    return {"outer_aucs": outer_aucs,
            "mean_auc": float(np.nanmean(outer_aucs)),
            "std_auc": float(np.nanstd(outer_aucs))}


def exhaustive_cv(make_model_task: Callable, cohort: SyntheticCohort,
                  cfg: Config, k: int = 10, apply_filter: bool = True,
                  max_pairs: Optional[int] = None, verbose: bool = True,
                  fold_parallel: bool = False, device="cuda", mesh=None
                  ) -> Dict[str, object]:
    """Every ordered (test, val) pair of one k-fold partition
    (train_exhausted.py:165-217); `max_pairs` keeps the first pairs only.
    `fold_parallel` trains every pair in one fold program; `mesh` as in
    `nested_cv`."""
    pairs = []
    for n, (ti, vi, s) in enumerate(
            splits.exhaustive_fold_pairs(cohort.labels, k, cfg.train.seed)):
        if max_pairs is not None and n >= max_pairs:
            break
        pairs.append((ti, vi, s))
    aucs: List[Tuple[int, int, float]] = []
    with no_tf32():
        if fold_parallel:
            fold_aucs = _run_folds(make_model_task, cohort,
                                   [s for _, _, s in pairs], cfg,
                                   apply_filter, verbose, device, mesh)
            for (ti, vi, _), auc in zip(pairs, fold_aucs):
                aucs.append((ti, vi, auc))
                if verbose:
                    print(f"[test={ti} val={vi}] auc={auc:.4f}")
        else:
            _hint_fold_parallel(cfg.train, len(pairs), verbose)
            for ti, vi, s in pairs:
                auc = _fold_auc(make_model_task, cohort, s, cfg,
                                apply_filter, device, mesh)
                aucs.append((ti, vi, auc))
                if verbose:
                    print(f"[test={ti} val={vi}] auc={auc:.4f}")
    vals = [a for _, _, a in aucs]
    return {"pairs": aucs, "mean_auc": float(np.nanmean(vals)),
            "std_auc": float(np.nanstd(vals))}


def cross_dataset_eval(model: torch.nn.Module, signals: np.ndarray,
                       labels: np.ndarray, fs: float = 250.0,
                       length: int = 2476, batch_size: int = 64
                       ) -> Dict[str, float]:
    """A trained signal model (eval mode, on its device) on another
    dataset with PTB-XL's preprocessing: baseline removal, a 5th-order
    40 Hz low-pass at `fs`, pad or crop to `length`, no per-sample
    z-score (evaluation_signal.py:20-39,171-219). Accuracy and F1 are
    taken at the F1-maximising threshold, which is reported beside them
    (evaluation_signal.py:190-196)."""
    x = preprocess.remove_baseline_drift(np.asarray(signals, np.float32))
    x = preprocess._filtfilt(preprocess.butter_lowpass_ptb(40.0, fs, 5), x)
    x = preprocess.pad_or_crop(x, length)
    device = next(model.parameters()).device
    model.eval()
    logits = []
    with no_tf32(), torch.no_grad():
        for i in range(0, len(x), batch_size):
            xb = torch.from_numpy(np.ascontiguousarray(x[i:i + batch_size]))
            logits.append(model(xb.to(device)[:, None, :]).float().cpu())
    logits = torch.cat(logits) if logits else torch.zeros((0, 2))
    probs = torch.softmax(logits, dim=-1)[:, 1].numpy()
    labels = np.asarray(labels)
    threshold, _ = M.find_best_threshold(labels, probs)
    out = M.summarize_binary(probs, labels, threshold=threshold)
    out["threshold"] = float(threshold)
    return out


def _load_weights(args) -> Dict[str, torch.Tensor]:
    """`--pth`: a reference ResNet1D-SE state dict (the port's models use
    the reference's names and layout); `--ckpt`: a `.msgpack` flax tree
    (JAX's converted checkpoints, `ecgmm-convert`; read by the port's own
    codec) or a checkpoint of the port's `train/checkpoint.py` (its
    model's state dict)."""
    if args.pth:
        sd = torch.load(args.pth, map_location="cpu", weights_only=True)
        return sd.state_dict() if hasattr(sd, "state_dict") else sd
    if args.ckpt.endswith(".msgpack"):
        from ecgmm_torch.tools.convert_pth import load_converted
        from ecgmm_torch.tools.weights import from_jax_resnet1d_se

        return from_jax_resnet1d_se(load_converted(args.ckpt))
    return torch.load(args.ckpt, map_location="cpu",
                      weights_only=True)["model"]


def _cross_cli(args) -> None:
    """The `cross` mode: a trained ResNet1D-SE on foreign signals (a
    hospital directory's, or the synthetic cohort's), its metrics printed
    as JSON; the runnable form of `python evaluation_signal.py`."""
    import json
    import os

    from ecgmm_torch.config import DataConfig
    from ecgmm_torch.data import align, sources, synthetic
    from ecgmm_torch.models.resnet1d_se import ResNet1DSE
    from ecgmm_torch.workloads.run import _device

    if args.data_dir:
        d = DataConfig(data_dir=args.data_dir)
        labels, _, ecg = sources.load_hospital_tables(
            os.path.join(d.data_dir, d.label_file),
            os.path.join(d.data_dir, d.clinical_file),
            os.path.join(d.data_dir, d.ecg_csv))
        labels = align.filter_and_map_labels(labels)
        common = sorted(set(labels["index"].astype(int).tolist())
                        & set(ecg.index.astype(int).tolist()))
        signals = ecg.loc(common).to_numpy(np.float32)
        labels = labels.set_index("index").loc(common)["label"].astype(
            np.int64)
    else:
        cohort = synthetic.make_cohort(n=args.n_synth,
                                       signal_len=args.length,
                                       img_hw=(16, 32))
        signals, labels = cohort.signals, cohort.labels
    model = ResNet1DSE(num_classes=2)
    model.load_state_dict(_load_weights(args), strict=True)
    model.to(_device(args.device))
    out = cross_dataset_eval(model, signals, labels, length=args.length)
    print(json.dumps({k: float(v) for k, v in out.items()}, indent=1))


def _clean(v):
    """NaN as None (strict JSON rejects a bare NaN), in lists too."""
    if isinstance(v, float) and not np.isfinite(v):
        return None
    if isinstance(v, list):
        return [_clean(x) for x in v]
    return v


def build_parser():
    """The argument parser of `main` (also how `tools/bench_cv.sh`'s
    command lines are checked)."""
    import argparse

    p = argparse.ArgumentParser(
        description=main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["nested", "exhaustive", "cross"])
    p.add_argument("--preset", default="fusion")
    p.add_argument("--n-synth", type=int, default=128)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None,
                   help="override the reference's fixed seed 42")
    p.add_argument("--cache-embeddings", action="store_true")
    p.add_argument("--fold-parallel", action="store_true",
                   help="train every fold at once in the fold program "
                        "(train/cv_parallel.py); pairs best with "
                        "--cache-embeddings on fusion presets")
    p.add_argument("--k", type=int, default=10,
                   help="exhaustive mode: number of folds")
    p.add_argument("--max-pairs", type=int, default=None,
                   help="exhaustive mode: bound the 90-pair sweep")
    p.add_argument("--pth", default=None,
                   help="cross mode: reference ResNet1D-SE .pth state dict")
    p.add_argument("--ckpt", default=None,
                   help="cross mode: a checkpoint of a port run "
                        "(train/checkpoint.py's .pt)")
    p.add_argument("--data-dir", default=None,
                   help="cross mode: hospital-layout data dir (default: "
                        "synthetic cohort)")
    p.add_argument("--length", type=int, default=2476,
                   help="cross mode: pad/crop length (reference "
                        "evaluation_signal.py:36-38)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--n-model", type=int, default=None,
                   help="model-axis size of the torchrun ranks' mesh "
                        "(sequential fits only)")
    return p


def main(argv=None):
    """The reference's `python train_kfold.py` (nested 5 x 3 CV,
    train_kfold.py:135-178), `python train_exhausted.py` (every (test,
    val) pair, train_exhausted.py:165-217) and `python
    evaluation_signal.py` (a trained signal model on another dataset,
    evaluation_signal.py:171-219), on the card unless --device cpu:

        python -m ecgmm_torch.train.cv nested --preset fusion
        python -m ecgmm_torch.train.cv exhaustive --k 10 --max-pairs 10
        python -m ecgmm_torch.train.cv cross --pth best_ptbxl.pth \\
            [--data-dir ./data]   # default: the synthetic cohort
    """
    import json

    from ecgmm_torch.data import synthetic
    from ecgmm_torch.workloads.run import (_device, apply_train_overrides,
                                           build_model_and_task, get_preset)

    p = build_parser()
    args = p.parse_args(argv)

    if args.mode == "cross":
        if not (args.pth or args.ckpt):
            p.error("cross mode needs --pth or --ckpt")
        return _cross_cli(args)
    if args.preset in ("signal_12lead", "physionet_crnn"):
        p.error(f"preset {args.preset!r} needs multi-lead / spectrogram "
                "inputs the CV harness does not materialize; use "
                "python -m ecgmm_torch.workloads.run for it")
    if args.max_pairs is not None and args.max_pairs < 1:
        p.error("--max-pairs must be >= 1")

    device = _device(args.device)
    device = init_distributed(device=args.device) or device
    cfg = apply_train_overrides(get_preset(args.preset), epochs=args.epochs,
                                cache_embeddings=args.cache_embeddings,
                                seed=args.seed)
    if args.n_model is not None:
        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, n_model=args.n_model))
    mesh = make_mesh(cfg.mesh, device)
    cohort = synthetic.make_cohort(
        n=args.n_synth, signal_len=cfg.data.signal_len,
        img_hw=(cfg.data.img_height, cfg.data.img_width),
        n_clinical=cfg.model.clinical_in_features)
    if args.mode == "nested":
        out = nested_cv(build_model_and_task, cohort, cfg,
                        fold_parallel=args.fold_parallel, device=device,
                        mesh=mesh, verbose=mesh.is_writer)
    else:
        out = exhaustive_cv(build_model_and_task, cohort, cfg, k=args.k,
                            max_pairs=args.max_pairs,
                            fold_parallel=args.fold_parallel, device=device,
                            mesh=mesh, verbose=mesh.is_writer)
    summary = {k: _clean(v) for k, v in out.items() if k != "pairs"}
    if mesh.is_writer:
        print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
