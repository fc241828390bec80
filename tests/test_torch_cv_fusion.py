"""The fusion side of the port's sequential CV slice against the JAX
package on the CPU (tests/test_torch_cv.py holds the signal side and the
harnesses): the cached-embedding fusion fold, the CV encoders of
`train/embed`, and the CLI at full width. The fusion model at a small
size (16x32 images, 192-sample signals, ResNet1D-SE base filters 8,
float32), 21-48 records, the port from JAX's initial weights with the
head's dropout 0.

Bars, and why:
  * the fold AUC within 1e-3 (a dozen test rows: equal rankings);
  * the CV encoders in eval mode: within 1e-5 of the largest component
    (float32 convolutions summed in other orders; the raw embeddings
    reach ~30);
  * the CLI, sequential against --fold-parallel (bf16, full width):
    mean AUC within 1e-3.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from ecgmm_tpu.config import Config as JaxConfig
from ecgmm_tpu.config import ModelConfig as JaxModelConfig
from ecgmm_tpu.config import TrainConfig as JaxTrainConfig
from ecgmm_tpu.data import synthetic as jax_synthetic
from ecgmm_tpu.models import jit_init
from ecgmm_tpu.train import cv as jax_cv
from ecgmm_tpu.train import embed as jax_embed
from ecgmm_tpu.train import optim as jax_optim
from ecgmm_tpu.train.state import create_state as jax_create_state
from ecgmm_tpu.workloads.run import build_model_and_task as jax_build
from ecgmm_torch.config import Config, ModelConfig, TrainConfig
from ecgmm_torch.data import splits, synthetic
from ecgmm_torch.tools.weights import from_jax_variables
from ecgmm_torch.train import cv, embed
from ecgmm_torch.workloads.run import build_model_and_task

torch.set_num_threads(2)
T, FILTERS = 192, 8


def _fusion_cfgs(**kw):
    t = dict(batch_size=16, num_epochs=3, lr=1e-3, schedule="constant",
             k_outer=2, k_inner=2, patience=2, plateau_patience=1,
             cache_embeddings=True)
    t.update(kw)
    m = dict(dtype="float32", dropout=0.0, signal_base_filters=FILTERS)
    d = dict(img_height=16, img_width=32, signal_len=T)
    port = Config(name="fusion", train=TrainConfig(**t),
                  model=ModelConfig(**m),
                  data=dataclasses.replace(Config().data, **d))
    jax_cfg = JaxConfig(name="fusion",
                        train=JaxTrainConfig(**t, donate_state=False),
                        model=JaxModelConfig(**m),
                        data=dataclasses.replace(JaxConfig().data, **d))
    return port, jax_cfg


def _cohort(n=48):
    kw = dict(n=n, signal_len=T, img_hw=(16, 32), n_clinical=2)
    return synthetic.make_cohort(**kw), jax_synthetic.make_cohort(**kw)


def test_fold_auc_equals_jax_fusion_cached_embeddings():
    """The cached fusion fold (test_nested_cv_fusion_cached_embeddings's
    setting): BatchNorm calibration on the fold's train split, each
    split encoded once, the head trained, scored best-on-test."""
    cohort, jcohort = _cohort()
    cfg, jcfg = _fusion_cfgs(num_epochs=2)
    split = next(splits.nested_kfold(cohort.labels, 2, 2, 42))[2][0]
    want = jax_cv._fold_auc(jax_build, jcohort, split, jcfg, None, False)
    model, _, init_args, _ = jax_build(jcfg)
    sd = from_jax_variables(jax.device_get(jit_init(
        model, jax.random.PRNGKey(jcfg.train.seed), *init_args)))

    def make(c, device="cpu"):
        m, task, freeze = build_model_and_task(c, device)
        m.load_state_dict(sd, strict=True)
        return m, task, freeze

    got = cv._fold_auc(make, cohort, split, cfg, False, "cpu")
    assert got == pytest.approx(want, abs=1e-3)


def test_cli_runs_sequential_and_fold_parallel(capsys):
    """`exhaustive --preset fusion --cache-embeddings` through the CLI at
    full width (bf16) on the CPU, sequential and with --fold-parallel:
    finite, equal summaries."""
    outs = []
    for extra in ([], ["--fold-parallel"]):
        cv.main(["exhaustive", "--preset", "fusion", "--cache-embeddings",
                 "--epochs", "1", "--n-synth", "32", "--k", "4",
                 "--max-pairs", "2", "--device", "cpu", *extra])
        out = capsys.readouterr().out
        summary = json.loads(out[out.index("{"):])
        assert np.isfinite(summary["mean_auc"])
        outs.append(summary)
    assert outs[0]["mean_auc"] == pytest.approx(outs[1]["mean_auc"],
                                                abs=1e-3)


# ---------------------------------------------------------- CV encoders

def _within_largest(got, want, rel=1e-5):
    """|got - want| <= rel * the largest |want| (the raw image embeddings
    reach ~30, where float32's spacing is 2e-6)."""
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def test_cv_encoders_equal_jax():
    """`encode_image_cohort` and `encode_sigcli_rows` against JAX's on one
    fusion model (eval mode, unshuffled batches, pad rows stripped)."""
    cohort, jcohort = _cohort(n=21)
    _, jcfg = _fusion_cfgs()
    jmodel, _, init_args, freeze = jax_build(jcfg)
    tx = jax_optim.make_optimizer(jcfg.train, 2)
    variables = jit_init(jmodel, jax.random.PRNGKey(0), *init_args)
    jstate = jax_create_state(variables, tx, jax.random.PRNGKey(0),
                              freeze_predicate=freeze)
    cfg, _ = _fusion_cfgs()
    model = build_model_and_task(cfg, "cpu")[0]
    model.load_state_dict(from_jax_variables(jax.device_get(variables)),
                          strict=True)
    want_img = jax_embed.encode_image_cohort(jmodel, jstate,
                                             jcohort.images, 8)
    got_img = embed.encode_image_cohort(
        model, torch.from_numpy(cohort.images).permute(0, 3, 1, 2)
        .contiguous(), 8)
    _within_largest(got_img, want_img)
    sig = cohort.signals.astype(np.float32)
    cli = cohort.clinical[:, :2].astype(np.float32)
    want = jax_embed.encode_sigcli_rows(jmodel, jstate, sig, cli, 8)
    got = embed.encode_sigcli_rows(model, torch.from_numpy(sig),
                                   torch.from_numpy(cli), 8)
    assert got_img.shape == (21, 512) and got[0].shape == (21, 128)
    for g, w in zip(got, want):
        _within_largest(g, w)
    assert model.image_encoder.training == model.signal_encoder.training
