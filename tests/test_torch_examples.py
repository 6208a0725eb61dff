"""The port's dataset-family drivers (`waveformer_tpu_torch/examples/`)
end to end on the CPU: each synthesizes its raw dataset and runs the five
steps through the port's scripts at `--cases 4 --epochs 1 --steps 3
--device cpu`, with the assertions of `tests/test_deploy_examples.py::
TestExampleDrivers` (a metrics array of (cases, rows, 2) and at least one
prediction). The drivers import no JAX; nothing here is compared
numerically, so no tolerance applies.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# metric rows per case: TC/WT/ET for BraTS, one per foreground class else
ROWS = {"brats2023": 3, "abdomen_ct": 2, "liver_ct": 2}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: the tier-1 run puts six pytest workers on
    the cores, and torch's thread pools then contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(ROWS))
def test_example_driver(name, tmp_path):
    mod = importlib.import_module(f"waveformer_tpu_torch.examples.{name}")
    workdir = tmp_path / name
    results = mod.main(["--workdir", str(workdir), "--cases", "4", "--epochs", "1",
                        "--steps", "3", "--device", "cpu"])
    assert (workdir / "result_metrics.npy").exists()
    metrics = np.load(workdir / "result_metrics.npy")
    assert metrics.ndim == 3 and metrics.shape[1:] == (ROWS[name], 2)
    assert np.array_equal(metrics, results)
    assert np.isfinite(metrics).all()
    preds = list((workdir / "predictions").glob("*.nii.gz"))
    assert preds


def test_drivers_keep_the_jax_flags():
    """`--device` replaces `--platform`; the other flags and defaults are the
    JAX drivers'."""
    from waveformer_tpu_torch.examples import arguments

    ap = arguments("", "./demo", "")
    args = ap.parse_args([])
    assert (args.raw_dir, args.cases, args.epochs, args.steps, args.device) == (
        None, 8, 4, 40, None)
    with pytest.raises(SystemExit):
        ap.parse_args(["--platform", "cpu"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the run without a CUDA device")
def test_driver_without_cuda_raises_before_any_work(tmp_path):
    """No CPU fallback: without `--device` a driver asks for the CUDA device
    and raises before it writes anything."""
    from waveformer_tpu_torch.examples import liver_ct

    with pytest.raises(RuntimeError, match="no CUDA device"):
        liver_ct.main(["--workdir", str(tmp_path / "liver")])
    assert not (tmp_path / "liver").exists()


@pytest.mark.parametrize("module", ["waveformer_tpu_torch.tools.bench_train",
                                    "waveformer_tpu_torch.examples.brats2023",
                                    "waveformer_tpu_torch.examples.abdomen_ct",
                                    "waveformer_tpu_torch.examples.liver_ct"])
def test_spawned_workers_import_no_torch(module):
    """Run as `python -m`, these modules are imported again by the training
    loader's spawned workers: importing one loads no torch (nor JAX)."""
    code = (f"import sys, {module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'waveformer_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
