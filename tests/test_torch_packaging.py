"""The port's console scripts (`pyproject.toml`, `ecgmm-torch-*`): each
resolves to a callable `main(argv=None)` of the port, one for each of the
JAX package's nine, which stay as they are."""

import importlib
import inspect
import pathlib
import tomllib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def scripts():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def test_port_console_scripts_resolve(scripts):
    port = {k: v for k, v in scripts.items() if k.startswith("ecgmm-torch-")}
    jax = {k: v for k, v in scripts.items()
           if not k.startswith("ecgmm-torch-")}
    assert sorted(k[len("ecgmm-torch-"):] for k in port) == sorted(
        k[len("ecgmm-"):] for k in jax)
    for name, target in port.items():
        mod_name, fn_name = target.split(":")
        assert mod_name.startswith("ecgmm_torch."), name
        assert mod_name.replace("ecgmm_torch.", "ecgmm_tpu.") == \
            jax["ecgmm-" + name[len("ecgmm-torch-"):]].split(":")[0], name
        fn = getattr(importlib.import_module(mod_name), fn_name)
        assert callable(fn), name
        assert "argv" in inspect.signature(fn).parameters, name
        assert inspect.signature(fn).parameters["argv"].default is None


def test_port_package_data_ships_the_sources():
    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert "csrc/*.cu" in data["ecgmm_torch.ops"]
    assert "*.cpp" in data["ecgmm_torch.native"]
    assert (REPO / "ecgmm_torch" / "native" / "imdecode.cpp").is_file()
