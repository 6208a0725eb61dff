"""The port's console scripts in `pyproject.toml` (`[project.scripts]`,
`wtpu-torch-*`): each names a callable `main` of the port's scripts, which
resolves through `importlib` without installing the package, beside the
JAX package's `wtpu-*` entry of the same step."""

import importlib
import os
import tomllib

import pytest

PYPROJECT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "pyproject.toml")
STEPS = {"rename": "rename_data", "preprocess": "preprocess", "train": "train",
         "predict": "predict", "metrics": "compute_metrics", "pretrain": "pretrain_ssl"}


def scripts():
    with open(PYPROJECT, "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


@pytest.mark.parametrize("step", sorted(STEPS))
def test_console_script_resolves(step):
    table = scripts()
    target = table[f"wtpu-torch-{step}"]
    assert target == f"waveformer_tpu_torch.scripts.{STEPS[step]}:main"
    # the JAX package's entry of the same step
    assert table[f"wtpu-{step}"] == f"waveformer_tpu.scripts.{STEPS[step]}:main"
    module, attr = target.split(":")
    assert callable(getattr(importlib.import_module(module), attr))


def test_every_port_script_is_listed():
    names = [k for k in scripts() if k.startswith("wtpu-torch-")]
    assert sorted(names) == sorted(f"wtpu-torch-{s}" for s in STEPS)
