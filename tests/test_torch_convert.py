"""The port's checkpoint tools against JAX's (`ecgmm_tpu/tools/
convert_pth.py`, `export_pth.py`, `tests/test_export_pth.py`), on the CPU.

- `tools/flax_msgpack.py` writes the bytes of
  `flax.serialization.msgpack_serialize`, a chunked array included, and
  reads flax's bytes back (bar: bytes equal, arrays equal);
- the import CLI (`.pth` -> `.msgpack`) writes JAX's CLI's bytes for each
  of the eight `--arch` values (bar: bytes equal);
- `--export` writes JAX's `export_pth` state dict: the same keys in the
  same order and equal tensors, from a `.msgpack` tree and from a port
  checkpoint (`.pt`, run directory);
- `cv cross --ckpt x.msgpack` on a tree JAX's CLI wrote prints JAX's
  metrics (bar: 1e-5, `tests/test_torch_cv.py`'s);
- a JAX orbax checkpoint directory is refused.
"""

import json

import numpy as np
import pytest
import torch
from flax import serialization

from ecgmm_tpu.tools import convert_pth as jax_convert
from ecgmm_tpu.tools import export_pth as jax_export
from ecgmm_torch.tools import convert_pth, flax_msgpack
from tests.test_export_pth import _build, _mint_sd

torch.set_num_threads(2)
ARCHS = sorted(jax_export.EXPORTERS)


def test_codec_bytes_equal_flax(monkeypatch):
    """Every leaf kind the codec writes: float and integer arrays of
    several sizes (fixext, ext8, ext16, ext32 bodies), numpy scalars,
    Python ints of every width, floats, strings, None, lists and unsorted
    nested keys; then the same tree with the chunk size lowered, so that
    an array is chunked; flax's bytes restore through the codec and the
    codec's through flax."""
    rng = np.random.default_rng(0)
    tree = {
        "params": {"z": rng.normal(size=(3, 4)).astype(np.float32),
                   "a": {"k": np.arange(300, dtype=np.int64),
                         "s": np.float32(2.5), "e": np.zeros((0, 3))}},
        "batch_stats": {"m": rng.normal(size=(70000,)).astype(np.float32)},
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                 -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 40],
        "f": 1.5, "n": None, "s": "hello" * 10, "b": True,
        "u": np.uint8(7),
    }
    assert flax_msgpack.msgpack_serialize(tree) == \
        serialization.msgpack_serialize(tree)
    back = flax_msgpack.msgpack_restore(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(back["batch_stats"]["m"],
                                  tree["batch_stats"]["m"])
    assert back["ints"] == tree["ints"] and back["s"] == tree["s"]
    assert back["params"]["a"]["s"] == np.float32(2.5)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 1000)
    chunked = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in chunked
    assert flax_msgpack.msgpack_serialize(tree) == chunked
    for restored in (flax_msgpack.msgpack_restore(chunked),
                     serialization.msgpack_restore(
                         flax_msgpack.msgpack_serialize(tree))):
        np.testing.assert_array_equal(restored["batch_stats"]["m"],
                                      tree["batch_stats"]["m"])
        np.testing.assert_array_equal(restored["params"]["a"]["k"],
                                      tree["params"]["a"]["k"])


def _pth(arch, path):
    """A reference-format state dict of `arch` (the replica models of
    `tests/test_export_pth.py`, BN statistics randomised) saved with
    torch.save; returns the numpy state dict."""
    tmodel, _ = _build(arch)
    sd = _mint_sd(tmodel, seed=len(arch))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return sd


@pytest.mark.parametrize("arch", ARCHS)
def test_import_cli_bytes_equal_jax(arch, tmp_path):
    """`.pth` -> `.msgpack`: the port's CLI writes JAX's CLI's bytes."""
    pth = tmp_path / "ref.pth"
    _pth(arch, pth)
    extra = ["--nhead", "4"] if arch == "transformer1d" else []
    jax_convert.main([str(pth), "--arch", arch, "--out",
                      str(tmp_path / "j.msgpack"), *extra])
    convert_pth.main([str(pth), "--arch", arch, "--out",
                      str(tmp_path / "p.msgpack"), *extra])
    want = (tmp_path / "j.msgpack").read_bytes()
    assert (tmp_path / "p.msgpack").read_bytes() == want
    tree = convert_pth.load_converted(str(tmp_path / "j.msgpack"))
    assert set(tree) == set(jax_convert.load_converted(
        str(tmp_path / "j.msgpack")))


def _assert_same_state_dict(got_path, want):
    got = torch.load(got_path, weights_only=True)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k


@pytest.mark.parametrize("arch", ARCHS)
def test_export_from_msgpack_equals_jax_export(arch, tmp_path):
    """`--export` of a `.msgpack` tree (JAX's import of a reference
    checkpoint): the `.pth` holds JAX's `export_pth` state dict, keys in
    its order, tensors equal (num_batches_tracked 0, the LSTM's summed
    bias in bias_ih with a zero bias_hh, TabNet's shared weights at every
    alias)."""
    pth = tmp_path / "ref.pth"
    _pth(arch, pth)
    extra = ["--nhead", "4"] if arch == "transformer1d" else []
    tree = tmp_path / "j.msgpack"
    jax_convert.main([str(pth), "--arch", arch, "--out", str(tree), *extra])
    jax_convert.main([str(tree), "--arch", arch, "--export", "--out",
                      str(tmp_path / "j.pth")])
    convert_pth.main([str(tree), "--arch", arch, "--export", "--out",
                      str(tmp_path / "p.pth")])
    want = jax_export.EXPORTERS[arch](jax_convert.load_converted(str(tree)))
    _assert_same_state_dict(tmp_path / "p.pth", want)
    _assert_same_state_dict(tmp_path / "p.pth",
                            torch.load(tmp_path / "j.pth", weights_only=True))


@pytest.mark.parametrize("arch", ["fusion_canonical", "crnn",
                                  "transformer1d"])
def test_export_from_port_checkpoint_equals_jax_export(arch, tmp_path):
    """`--export` of a port checkpoint (a run directory's `best.pt` and
    the `.pt` file itself, the model state dict under "model"): JAX's
    export of the same weights."""
    sd = _pth(arch, tmp_path / "ref.pth")
    run = tmp_path / "run"
    run.mkdir()
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               run / "best.pt")
    importer = _build(arch)[1]
    want = jax_export.EXPORTERS[arch](importer(sd))
    for src in (run, run / "best.pt"):
        out = tmp_path / "p.pth"
        convert_pth.main([str(src), "--arch", arch, "--export", "--which",
                          "best", "--out", str(out)])
        _assert_same_state_dict(out, want)


def test_orbax_directory_is_refused(tmp_path):
    """A JAX orbax checkpoint: the message names JAX's own export."""
    d = tmp_path / "orbax_run"
    (d / "best").mkdir(parents=True)
    (d / "best" / "_CHECKPOINT_METADATA").write_text("{}")
    for src in (d, d / "best"):
        with pytest.raises(ValueError, match="ecgmm_tpu.tools.convert_pth"):
            convert_pth.main([str(src), "--arch", "resnet1d_se", "--export",
                              "--out", str(tmp_path / "x.pth")])
    with pytest.raises(FileNotFoundError, match="no last.pt"):
        convert_pth.load_port_state_dict(str(tmp_path), which="last")


def test_cv_cross_reads_jax_msgpack(tmp_path, capsys):
    """`cv cross --ckpt x.msgpack`, the tree written by JAX's CLI from a
    reference ResNet1D-SE checkpoint: the port prints JAX's metrics."""
    from ecgmm_tpu.train import cv as jax_cv
    from ecgmm_torch.train import cv

    pth = tmp_path / "best.pth"
    _pth("resnet1d_se", pth)
    tree = tmp_path / "sig.msgpack"
    jax_convert.main([str(pth), "--arch", "resnet1d_se", "--out",
                      str(tree)])
    argv = ["cross", "--ckpt", str(tree), "--n-synth", "16", "--length",
            "512"]
    jax_cv.main(argv)
    out = capsys.readouterr().out
    want = json.loads(out[out.index("{"):])
    cv.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    got = json.loads(out[out.index("{"):])
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), abs=1e-5), k
