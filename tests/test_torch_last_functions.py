"""The JAX package's functions the port gained last, each against its JAX
counterpart on the CPU: `serve/report.py`'s OpenAI backend
(`parse_sections`, `_chat_messages`, `openai_report` with fake openai<1.0
and openai>=1.0 clients, offline), `train/metrics.
find_best_threshold_multiclass`, `data/synthetic.write_fixture_tree`
(the same files, read back by each package's loader to the same arrays)
and `tools/bench_cv.sh` (its command lines parsed by the port's CV
argument parser)."""

import dataclasses
import os
import re
import shlex
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from ecgmm_tpu.config import get_preset as jax_get_preset
from ecgmm_tpu.data import synthetic as jax_synthetic
from ecgmm_tpu.serve import report as jax_report
from ecgmm_tpu.train import metrics as jax_metrics
from ecgmm_tpu.workloads import run as jax_run
from ecgmm_torch.config import get_preset
from ecgmm_torch.data import synthetic
from ecgmm_torch.serve import report
from ecgmm_torch.train import cv, metrics
from ecgmm_torch.workloads import run as port_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GPT_TEXT = (
    "### [RR 간격]\nrr 소견\n### [QRS 파형]\n---qrs 소견---\n### [T파]\n"
    "t 소견\n### [P파]\np 소견\n### [임상 권고]\n- 권고\n"
    "### [RR 간격]\n다시 rr\n### [기타]\n무시\n"
)


@pytest.mark.parametrize("text", [
    _GPT_TEXT, "", "no sections at all", "### [T파]\n", "### [T파]t",
    "### [P파]\n- a\n- b\n---\n### [임상 권고]\n---권고---",
])
def test_parse_sections_matches_jax(text):
    assert report.SECTIONS == jax_report.SECTIONS
    assert report.parse_sections(text) == jax_report.parse_sections(text)


@pytest.mark.parametrize("abnormal,probability,age,sex", [
    (True, 0.87, 70, "M"), (False, 0.123, None, None), (True, 1.0, 41.5, "F"),
])
def test_chat_messages_match_jax(abnormal, probability, age, sex):
    args = ("b64png", abnormal, probability, age, sex)
    assert report._chat_messages(*args) == jax_report._chat_messages(*args)


def _v0_client(seen):
    class ChatCompletion:
        @staticmethod
        def create(model, messages, max_tokens):
            seen.append(dict(model=model, messages=messages,
                             max_tokens=max_tokens))
            return {"choices": [{"message": {"content": _GPT_TEXT}}]}

    return SimpleNamespace(ChatCompletion=ChatCompletion)


def _v1_module(seen):
    class _Completions:
        def create(self, model, messages, max_tokens):
            seen.append(dict(model=model, messages=messages,
                             max_tokens=max_tokens))
            msg = SimpleNamespace(content=_GPT_TEXT)
            return SimpleNamespace(choices=[SimpleNamespace(message=msg)])

    class _Client:
        def __init__(self):
            self.chat = SimpleNamespace(completions=_Completions())

    class _RemovedProxy:  # the real openai>=1.0 module keeps this name
        @staticmethod
        def create(**kw):
            raise RuntimeError("APIRemovedInV1")

    return SimpleNamespace(OpenAI=_Client, ChatCompletion=_RemovedProxy)


@pytest.mark.parametrize("sdk", ["v0", "v1", "v1-client"])
def test_openai_report_matches_jax(sdk):
    """Both SDK branches (tests/test_serve.py's fakes): the same request
    (model, messages, max_tokens) and the same sections."""
    outs, seens = [], []
    for mod in (jax_report, report):
        seen = []
        if sdk == "v0":
            client = _v0_client(seen)
        elif sdk == "v1":
            client = _v1_module(seen)
        else:
            client = _v1_module(seen).OpenAI()
        outs.append(mod.openai_report("b64", abnormal=True, probability=0.9,
                                      age=70, sex="F", client=client))
        seens.append(seen)
    assert outs[0] == outs[1]
    assert seens[0] == seens[1] and len(seens[0]) == 1
    assert seens[0][0]["model"] == "gpt-4o"
    assert outs[1]["RR 간격"] == "다시 rr" and outs[1]["QRS 파형"] == "qrs 소견"


def test_openai_report_without_the_package_raises(monkeypatch):
    """The import is gated: without `openai` (and no client) it raises
    ImportError, as in JAX; the served request keeps the rule-based
    report."""
    monkeypatch.setitem(sys.modules, "openai", None)
    for mod in (jax_report, report):
        with pytest.raises(ImportError):
            mod.openai_report("b64", abnormal=False, probability=0.1)
    with open(os.path.join(REPO, "ecgmm_torch", "serve", "request.py")) as f:
        src = f.read()
    assert "rule_based_report(" in src and "openai_report" not in src


@pytest.mark.parametrize("n_classes,positive_class,seed", [
    (3, 1, 0), (3, 0, 1), (3, 2, 2), (4, 1, 3), (4, 3, 4),
])
def test_find_best_threshold_multiclass_matches_jax(n_classes,
                                                    positive_class, seed):
    rng = np.random.default_rng(seed)
    n = 200
    y = rng.integers(0, n_classes, n)
    logits = rng.normal(size=(n, n_classes)) + 1.5 * np.eye(n_classes)[y]
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    # ties: probabilities on the grid and repeated rows
    probs[:20, positive_class] = np.round(probs[:20, positive_class] * 20) / 20
    probs[20:40] = probs[0]
    want = jax_metrics.find_best_threshold_multiclass(y, probs,
                                                      positive_class)
    got = metrics.find_best_threshold_multiclass(y, probs, positive_class)
    assert got[0] == want[0]
    # JAX's F1 is a float32; the port's the same ratio in float64
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def test_find_best_threshold_multiclass_tie_keeps_first():
    """All thresholds give the same F1 (every positive scores 0.95, every
    negative 0.02): both return the grid's first value."""
    y = np.array([1, 0, 2, 1, 0, 2])
    probs = np.where(np.eye(3)[y] > 0, 0.95, 0.025)
    probs = probs / probs.sum(1, keepdims=True)
    want = jax_metrics.find_best_threshold_multiclass(y, probs)
    got = metrics.find_best_threshold_multiclass(y, probs)
    assert got[0] == want[0] == pytest.approx(0.1)
    assert got[1] == pytest.approx(want[1]) == 1.0


def test_fixture_tree_same_files_and_arrays(tmp_path):
    """The same bytes in every file (the JPEGs at Pillow's default
    quality 75), and each package's hospital loader on its own tree gives
    the same arrays (the filtered signals within one float32 ulp)."""
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    jc = jax_synthetic.write_fixture_tree(str(jroot), n=40)
    pc = synthetic.write_fixture_tree(str(proot), n=40)
    np.testing.assert_array_equal(pc.signals, jc.signals)
    files = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    assert len(files) == 3 + 40
    assert files == sorted(os.path.relpath(os.path.join(d, f), proot)
                           for d, _, fs in os.walk(proot) for f in fs)
    for rel in files:
        with open(jroot / rel, "rb") as a, open(proot / rel, "rb") as b:
            assert a.read() == b.read(), rel
    cfgs = []
    for get, root in ((jax_get_preset, jroot), (get_preset, proot)):
        cfg = get("fusion")
        cfgs.append(dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, data_dir=str(root), img_height=32, img_width=40)))
    want = jax_run.load_data(cfgs[0], "hospital", 0)
    got = port_run.load_data(cfgs[1], "hospital", 0, device="cpu")
    for split in ("train", "val", "test"):
        j, p = getattr(want, split), getattr(got, split)
        assert p.n == j.n > 0
        np.testing.assert_array_equal(p.indices, j.indices)
        np.testing.assert_array_equal(p.labels.numpy(), np.asarray(j.labels))
        np.testing.assert_array_equal(
            p.images.numpy(), np.asarray(j.images).transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(p.clinical.numpy(),
                                      np.asarray(j.clinical))
        # the hospital filter in float64: JAX's native library fuses
        # multiply-adds (-march=native), the port's does not, so a float32
        # sample may land one ulp apart (tests/test_torch_native_host.py)
        np.testing.assert_array_max_ulp(p.signals.numpy(),
                                        np.asarray(j.signals), maxulp=1)


def test_bench_cv_script_runs_the_jax_scripts_runs_through_the_port():
    """The port's script: valid bash, the JAX script's 8 runs (tags and
    arguments) through `python -m ecgmm_torch.train.cv`, each command line
    accepted by the port's CV parser; its logs stay in the checkout."""
    port = os.path.join(REPO, "ecgmm_torch", "tools", "bench_cv.sh")
    subprocess.run(["bash", "-n", port], check=True)

    def runs(path, module):
        with open(path) as f:
            src = f.read()
        env = dict(re.findall(r'^(B|N)="([^"]*)"$', src, re.MULTILINE))
        assert env["B"] == f"python -m {module}"
        out = []
        for line in re.findall(r"^run (.*)$", src, re.MULTILINE):
            words = shlex.split(line.replace("$B", env["B"])
                                .replace("$N", env["N"]))
            out.append((words[0], words[1:]))
        return out, src

    jax_runs, _ = runs(os.path.join(REPO, "ecgmm_tpu", "tools",
                                    "bench_cv.sh"), "ecgmm_tpu.train.cv")
    port_runs, src = runs(port, "ecgmm_torch.train.cv")
    assert len(port_runs) == 8
    assert [(t, a[3:]) for t, a in port_runs] == \
        [(t, a[3:]) for t, a in jax_runs]
    parser = cv.build_parser()
    for tag, argv in port_runs:
        assert argv[:3] == ["python", "-m", "ecgmm_torch.train.cv"]
        args = parser.parse_args(argv[3:])
        assert args.preset == "fusion" and args.n_synth == 244
        assert args.epochs == 8
        assert args.fold_parallel == ("_par_" in tag)
        assert args.cache_embeddings == tag.endswith("_cached")
        assert (args.mode, args.k) == (
            ("nested", 10) if tag.startswith("nested") else ("exhaustive", 10))
    assert "/tmp" not in src
