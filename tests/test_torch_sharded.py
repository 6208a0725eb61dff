"""Case-sharded inference and the multi-process entry points of the port.

`Predictor.predict_cases_sharded` against serial `predict_cases`, case for
case (mirroring tests/test_sharded_inference.py for the JAX package): the
union over the ranks of a data mesh, each rank run here in turn on a mesh
of its own (the method reads only the rank and the size; no label map
crosses between ranks), in both layouts, with and without properties, one
case resampled. Then `scripts.predict --sharded on` and `scripts.train
--multihost` at 2 ranks: child processes over gloo
(`tests/torch_dist_child.py`, `file://` rendezvous, 60 s group timeout,
each joined with a timeout), spawned once for the module. They import no
JAX, and neither does this file: the comparisons here are the port against
itself, exact (`np.array_equal` label maps and affines, `torch.equal`
masters). Last, the two commands the README gives, through `torchrun
--standalone` (its rendezvous store takes a port the system assigns):
`scripts.predict --sharded auto` and `scripts.train --multihost`, which
join the group from the environment `torchrun` sets (`env://`).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from waveformer_tpu_torch.data.dataset import get_train_val_test_loader_from_train
from waveformer_tpu_torch.inference import Predictor, SlidingWindowInferer
from waveformer_tpu_torch.parallel.mesh import Mesh, MeshSpec
from waveformer_tpu_torch.scripts import predict
from waveformer_tpu_torch.tools import synthetic_cases
from waveformer_tpu_torch.training.checkpoint import load_params_npz, params_tree
from waveformer_tpu_torch.utils import nifti

CHILD = os.path.join(os.path.dirname(__file__), "torch_dist_child.py")
WORLD = 2
JOIN_TIMEOUT_S = 240
NET = dict(img_size=(32, 32, 32), patch_size=2, in_chans=4, out_chans=4,
           embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 8),
           decom_levels=(3, 2, 1, 0), drop_path_rate=0.0)
# the serving tree: raw (X, Y, Z) under a non-RAS affine; the second case is
# stored at another shape than its crop, so its logits are resampled
RAW_SHAPE = (46, 50, 42)
SOURCE_AFFINE = np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)
BBOXES = [((1, 41), (3, 47), (5, 41)), ((2, 40), (2, 48), (6, 42)), ((0, 38), (4, 46), (4, 40))]
STORED = [(40, 44, 36), (40, 44, 36), (38, 42, 36)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the tier-1 run puts six pytest
    workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# predict_cases_sharded: the union over the ranks is the serial output
# --------------------------------------------------------------------------- #


def _predictor_fn(cf: bool):
    """Deterministic nonlinear patch predictor (stands in for the model)."""
    kernel = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 2))
                              .astype(np.float32))

    def fn(patches):
        eq = "bcdhw,co->bodhw" if cf else "bdhwc,co->bdhwo"
        h = torch.einsum(eq, patches.float(), kernel)
        return torch.tanh(h) + 0.1 * h
    return fn


def _cases(cf: bool):
    """5 cases of three shapes; case 3 needs a logit resample (its crop
    differs from its stored shape)."""
    rng = np.random.default_rng(0)
    shapes = [(20, 18, 16), (20, 18, 16), (16, 16, 16), (24, 20, 18), (20, 18, 16)]
    vols, props = [], []
    for i, s in enumerate(shapes):
        vols.append(rng.standard_normal((4, *s) if cf else (*s, 4)).astype(np.float32))
        crop = tuple(d + 2 for d in s) if i == 3 else s
        props.append({"shape_before_cropping": tuple(d + 4 for d in crop),
                      "bbox_used_for_cropping": [[2, 2 + d] for d in crop],
                      "shape_after_cropping_before_resample": crop})
    return vols, props


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("with_props", [True, False])
@pytest.mark.parametrize("layout", ["channels_first", "channels_last"])
def test_sharded_union_matches_serial(layout, with_props, world):
    cf = layout == "channels_first"
    inferer = SlidingWindowInferer(roi_size=(16, 16, 16), sw_batch_size=2, overlap=0.5,
                                   mirror_axes=(0, 1, 2), layout=layout)
    pred = Predictor(inferer, device="cpu")
    fn = _predictor_fn(cf)
    vols, props = _cases(cf)
    props = props if with_props else None
    serial = list(pred.predict_cases(vols, fn, out_channels=2, properties_list=props))
    union, per_rank = {}, []
    for rank in range(world):
        got = list(pred.predict_cases_sharded(vols, fn, out_channels=2, properties_list=props,
                                              mesh=Mesh(MeshSpec(data=world), rank)))
        idx = [i for i, _ in got]
        assert idx == sorted(idx)  # ascending, and no padded repeat
        assert not set(idx) & set(union)
        per_rank.append(idx)
        union.update(got)
    assert sorted(union) == list(range(len(vols)))
    # the sampler's contiguous rows (`shard_cases_for_eval`)
    per = -(-len(vols) // world)
    assert per_rank == [list(range(r * per, min((r + 1) * per, len(vols))))
                        for r in range(world)]
    for i, ref in enumerate(serial):
        np.testing.assert_array_equal(union[i], ref, err_msg=f"case {i} ({layout})")


def test_sharded_without_group_is_serial():
    """No mesh and no process group: one rank holds every case."""
    inferer = SlidingWindowInferer(roi_size=(16, 16, 16), sw_batch_size=2, overlap=0.5,
                                   layout="channels_last")
    pred = Predictor(inferer, device="cpu")
    vols, props = _cases(False)
    got = list(pred.predict_cases_sharded(vols, _predictor_fn(False), 2, props))
    assert [i for i, _ in got] == list(range(len(vols)))


# --------------------------------------------------------------------------- #
# the scripts at 2 ranks
# --------------------------------------------------------------------------- #


def _serving_config(root, out):
    return f"""\
data_dir: "{root}/fullres"
logdir: "{root}/logs/"
model_name: "sharded_test"
data_list_path: "{root}/data_list"
split_path: "default_split"
roi_size: [32, 32, 32]
seed: 42
compute_dtype: "float32"
label_mode: "brats"
prediction:
  patch_size: [32, 32, 32]
  sw_batch_size: 4
  overlap: 0.25
  mirror_axes: [0, 1, 2]
  raw_spacing: [1.0, 1.0, 1.0]
  prediction_save: "{out}"
network:
  model_type: "Waveformer"
  in_channels: 4
  out_channels: 4
  img_size: [32, 32, 32]
  patch_size: 2
  transformer:
    embed_dims: [8, 16, 32, 64]
    depths: [1, 1, 1, 1]
    num_heads: [2, 4, 8, 8]
    decom_levels: [3, 2, 1, 0]
    drop_path_rate: 0.0
"""


def _training_config(root):
    return f"""\
data_dir: "{root}/fullres"
logdir: "{root}/logs/"
model_name: "multihost_test"
data_list_path: "{root}/data_list"
split_path: "default_split"
roi_size: [32, 32, 32]
seed: 3
compute_dtype: "float32"
batch_size: 2
max_epoch: 2
num_steps_per_epoch: 2
val_every: 1
val_patches_per_epoch: 2
train_process: 0
lr: 0.0001
label_mode: "brats"
logging:
  log_file: "{root}/logs/train.log"
network:
  in_channels: 4
  out_channels: 4
  img_size: [32, 32, 32]
  patch_size: 2
  transformer:
    embed_dims: [8, 16, 32, 64]
    depths: [1, 1, 1, 1]
    num_heads: [2, 4, 8, 8]
    decom_levels: [3, 2, 1, 0]
    drop_path_rate: 0.1
"""


@pytest.fixture(scope="module")
def scripts_run(tmp_path_factory):
    """The serving and training trees; 2 ranks run both scripts while this
    process runs `scripts.predict --sharded off` on the same tree."""
    workdir = str(tmp_path_factory.mktemp("sharded_scripts"))
    serving = os.path.join(workdir, "serving")
    names = synthetic_cases.write_cases(serving, np.random.default_rng(3), RAW_SHAPE, BBOXES,
                                        SOURCE_AFFINE, STORED)
    synthetic_cases.write_checkpoint(
        os.path.join(serving, "logs", "model", "best_model_0.5000_sharded_test.npz"), NET,
        seed=0)
    paths = {"names": names, "serving": serving,
             "serial": os.path.join(serving, "pred_serial"),
             "sharded": os.path.join(serving, "pred_sharded"),
             "torchrun": os.path.join(serving, "pred_torchrun")}
    for tag in ("serial", "sharded", "torchrun"):
        with open(os.path.join(serving, f"config_{tag}.yaml"), "w") as f:
            f.write(_serving_config(serving, paths[tag]))
    training = os.path.join(workdir, "training")
    synthetic_cases.write_training_cases(os.path.join(training, "fullres"), n=4,
                                         shape=(40, 44, 36), seed=0)
    with open(os.path.join(training, "config.yaml"), "w") as f:
        f.write(_training_config(training))
    paths["training"] = training
    # the serving split before the ranks start: this process's serial run
    # reads the same tree meanwhile
    get_train_val_test_loader_from_train(
        os.path.join(serving, "fullres"),
        test_list_path=os.path.join(serving, "data_list", "test_list.pkl"),
        split_dir=os.path.join(serving, "data_list", "default_split"))
    torch.save({"predict_config": os.path.join(serving, "config_sharded.yaml"),
                "prediction_dir": paths["sharded"],
                "train_config": os.path.join(training, "config.yaml")},
               os.path.join(workdir, "inputs.pt"))
    procs = [subprocess.Popen([sys.executable, CHILD, "scripts", str(r), str(WORLD), workdir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        paths["serial_summary"] = predict.main(
            ["--config", os.path.join(serving, "config_serial.yaml"), "--device", "cpu",
             "--tta", "2", "--sharded", "off"])
        logs = [p.communicate(timeout=JOIN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    paths["ranks"] = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                      for r in range(WORLD)]
    return paths


def test_predict_sharded_writes_each_case_once(scripts_run):
    ranks = scripts_run["ranks"]
    # 3 cases over 2 ranks: rank 0 takes cases 0-1, rank 1 case 2 (its
    # padded repeat of case 0 dropped)
    assert [r["predict"]["cases"] for r in ranks] == [2, 1]
    want = sorted(n + ".nii.gz" for n in scripts_run["names"])
    assert sorted(os.listdir(scripts_run["sharded"])) == want
    assert scripts_run["serial_summary"]["cases"] == 3


@pytest.mark.parametrize("case", range(len(BBOXES)))
def test_predict_sharded_equals_serial(scripts_run, case):
    name = scripts_run["names"][case] + ".nii.gz"
    got = nifti.load(os.path.join(scripts_run["sharded"], name))
    want = nifti.load(os.path.join(scripts_run["serial"], name))
    assert got.data.shape == RAW_SHAPE
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.affine, want.affine)


def test_train_multihost_ranks_hold_equal_masters(scripts_run):
    trained = [r["train"] for r in scripts_run["ranks"]]
    assert all(t["mesh"] == {"data": WORLD, "spatial": 1, "tensor": 1} for t in trained)
    assert all(t["global_step"] == 4 for t in trained)
    first = trained[0]["params"]
    assert all(torch.equal(t["params"][k], first[k]) for t in trained[1:] for k in first)


def test_train_multihost_rank0_alone_writes(scripts_run):
    trained = [r["train"] for r in scripts_run["ranks"]]
    assert [t["wrote"] for t in trained] == [True, False]
    model_dir = os.path.join(scripts_run["training"], "logs", "model")
    (final,) = [f for f in os.listdir(model_dir)
                if f.startswith("final_model_") and f.endswith(".npz")]
    saved = load_params_npz(os.path.join(model_dir, final))
    want = params_tree(trained[0]["params"], NET["depths"])

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(v)

    got = dict(leaves(saved))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in leaves(want)}
    for k, v in leaves(want):
        np.testing.assert_array_equal(got[k], v)
    with open(os.path.join(scripts_run["training"], "logs", "train.log")) as f:
        assert "mesh {'data': 2" in f.read()


def test_split_is_written_once(scripts_run):
    """Rank 0 persists the train/val split first; both ranks read it."""
    split = os.path.join(scripts_run["training"], "data_list", "default_split")
    with open(os.path.join(split, "train_list.pkl"), "rb") as f:
        assert len(pickle.load(f)) == 3


# --------------------------------------------------------------------------- #
# the README's torchrun commands
# --------------------------------------------------------------------------- #

TORCHRUN_TIMEOUT_S = 240


def _torchrun(*args):
    """`torchrun --standalone --nproc-per-node 2 -m ...` from the repository
    root, one torch thread a process; returns its combined output."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={WORLD}", "-m", *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=TORCHRUN_TIMEOUT_S)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    return out.stdout + out.stderr


def test_torchrun_predict_sharded_auto(scripts_run):
    """`--sharded auto` under torchrun: two processes, so sharded; each
    writes its own cases, and the files equal the serial run's."""
    log = _torchrun("waveformer_tpu_torch.scripts.predict", "--config",
                    os.path.join(scripts_run["serving"], "config_torchrun.yaml"),
                    "--device", "cpu", "--tta", "2")
    assert "case-sharded inference: rank 1 of 2" in log
    for name in scripts_run["names"]:
        got = nifti.load(os.path.join(scripts_run["torchrun"], name + ".nii.gz"))
        want = nifti.load(os.path.join(scripts_run["serial"], name + ".nii.gz"))
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.affine, want.affine)


def test_torchrun_train_multihost(tmp_path):
    root = str(tmp_path)
    synthetic_cases.write_training_cases(os.path.join(root, "fullres"), n=4,
                                         shape=(40, 44, 36), seed=0)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        f.write(_training_config(root))
    _torchrun("waveformer_tpu_torch.scripts.train", "--multihost", "--device", "cpu",
              "--config", os.path.join(root, "config.yaml"))
    names = os.listdir(os.path.join(root, "logs", "model"))
    assert sum(n.startswith("final_model_") and n.endswith(".npz") for n in names) == 1
    with open(os.path.join(root, "logs", "train.log")) as f:
        assert "mesh {'data': 2" in f.read()
