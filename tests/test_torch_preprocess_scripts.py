"""The port's front-end scripts (`scripts/rename_data.py`,
`scripts/convert_split.py`, `scripts/preprocess.py`) against the JAX
package's, on the same raw trees.

Each pair of runs writes into its own folder, and the two output trees must
be file for file equal: the same names, the same arrays in every `.npz`,
the same properties in every `.pkl` after unpickling, the same `plans.json`
and the same printed plan. The raw inputs are NIfTIs, compared (where a
script leaves them) by their decoded data and affine, never by their bytes:
the port writes gzip level 1, the JAX package level 9. The pools run
in-process (`--num-processes 1`).
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest

from waveformer_tpu.scripts import convert_split as jax_convert_split
from waveformer_tpu.scripts import preprocess as jax_preprocess
from waveformer_tpu.scripts import rename_data as jax_rename_data
from waveformer_tpu_torch.data.planning import Plans
from waveformer_tpu_torch.scripts import convert_split, preprocess, rename_data
from waveformer_tpu_torch.tools import synthetic_cases
from waveformer_tpu_torch.utils import nifti

from test_torch_preprocessing import assert_same, assert_same_tree

LPS = np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)
KINDS = ("mri", "mri-global", "ct", "ct-organs", "multi-input")


def _save(path, data, affine):
    nifti.save(nifti.NiftiImage(data=data, affine=np.asarray(affine, np.float32)), str(path))


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Renamed raw trees: BraTS (`brats/{case}/{t2w,…,seg}.nii.gz`, 3 cases,
    one of them at 1 × 1 × 3.5 mm), flat CT and per-organ masks."""
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(11)
    brats = str(root / "brats")
    synthetic_cases.write_raw_cases(brats, rng, (30, 34, 28), LPS, 2)
    aniso = os.path.join(str(root), "aniso")
    synthetic_cases.write_raw_cases(aniso, rng, (32, 30, 12),
                                    np.diag([1.0, 1.0, 3.5, 1.0]), 1, margin=(3, 3, 1))
    shutil.move(os.path.join(aniso, "BraTS-GLI-00000-000"),
                os.path.join(brats, "BraTS-GLI-00002-000"))
    for f in os.listdir(os.path.join(brats, "BraTS-GLI-00002-000")):
        os.rename(os.path.join(brats, "BraTS-GLI-00002-000", f),
                  os.path.join(brats, "BraTS-GLI-00002-000", f.replace("00000", "00002")))
    rename_data.rename_dataset(brats)
    ct = root / "ct"
    os.makedirs(ct)
    for i in range(2):
        vol = rng.normal(40.0, 120.0, (30, 32, 20)).astype(np.float32)
        seg = np.zeros((30, 32, 20), np.int8)
        seg[8:20, 8:20, 6:14] = 1
        seg[12:16, 12:16, 8:11] = 2
        _save(ct / f"volume-{i}.nii.gz", vol + 60.0 * (seg > 0), np.diag([0.8, 0.8, 2.5, 1.0]))
        _save(ct / f"segmentation-{i}.nii.gz", seg, np.diag([0.8, 0.8, 2.5, 1.0]))
    for name in ("BDMAP_00000001", "BDMAP_00000002"):
        segs = root / "atlas" / name / "segmentations"
        os.makedirs(segs)
        _save(root / "atlas" / name / "ct.nii.gz",
              rng.normal(30.0, 100.0, (28, 28, 16)).astype(np.float32), LPS)
        for organ, box in (("liver", np.s_[4:14, 4:14, 4:10]), ("spleen", np.s_[10:20, 10:20, 6:12])):
            m = np.zeros((28, 28, 16), np.uint8)
            m[box] = 1
            _save(segs / f"{organ}.nii.gz", m, LPS)
    return str(root)


def _args(kind, raw):
    """The preprocess flags of each dataset type."""
    return {
        "mri": ["--raw-dir", os.path.join(raw, "brats")],
        "mri-global": ["--raw-dir", os.path.join(raw, "brats"), "--global-size", "12", "14", "10"],
        "ct": ["--raw-dir", os.path.join(raw, "ct"), "--foreground-classes", "1", "2"],
        "ct-organs": ["--raw-dir", os.path.join(raw, "atlas"),
                      "--organ-list", "liver.nii.gz", "spleen.nii.gz"],
        "multi-input": ["--raw-dir", os.path.join(raw, "brats"),
                        "--modalities", "t1c.nii.gz", "t2f.nii.gz",
                        "--regions", "1,2,3", "2,3", "3"],
    }[kind] + ["--dataset-type", kind, "--num-processes", "1"]


def _run_both(args, tmp_path, capsys, out_flag=True):
    """Run JAX's and the port's `preprocess.main` with `args` (each with its
    own `--out-dir` unless `out_flag` is false) and return the two output
    folders, the port's return value and the printed plans."""
    outs, printed = {}, {}
    for tag, mod in (("jax", jax_preprocess), ("port", preprocess)):
        outs[tag] = str(tmp_path / tag)
        got = mod.main(args + (["--out-dir", outs[tag]] if out_flag else []))
        text = capsys.readouterr().out
        printed[tag] = text.rsplit("preprocessed ", 1)[0]
        if tag == "port":
            ret = got
    return outs, ret, printed


@pytest.mark.parametrize("kind", KINDS)
def test_preprocess_main_matches_jax(raw, tmp_path, capsys, kind):
    outs, done, printed = _run_both(_args(kind, raw), tmp_path, capsys)
    assert printed["port"] == printed["jax"]
    assert_same_tree(outs["port"], outs["jax"])
    with open(os.path.join(outs["port"], "plans.json")) as f, \
            open(os.path.join(outs["jax"], "plans.json")) as g:
        assert json.load(f) == json.load(g)
    names = sorted(f[:-4] for f in os.listdir(outs["port"]) if f.endswith(".npz"))
    assert done == names and len(names) >= 2
    plans = Plans.load(os.path.join(outs["port"], "plans.json"))
    assert plans.normalization == ("zscore" if kind in ("mri", "mri-global") else "ct")
    if kind == "mri-global":
        with np.load(os.path.join(outs["port"], names[0] + ".npz")) as z:
            assert z["data_global"].shape[1:] == (12, 14, 10)
    if kind == "multi-input":
        with open(os.path.join(outs["port"], names[0] + ".pkl"), "rb") as f:
            assert list(pickle.load(f)["class_locations"]) == [(1, 2, 3), (2, 3), 3]


def test_preprocess_plan_only(raw, tmp_path, capsys):
    outs, done, printed = _run_both(_args("mri", raw) + ["--plan-only"], tmp_path, capsys)
    assert done == []
    assert printed["port"] == printed["jax"] and printed["port"].strip()
    assert os.listdir(outs["port"]) == os.listdir(outs["jax"]) == ["plans.json"]
    with open(os.path.join(outs["port"], "plans.json")) as f, \
            open(os.path.join(outs["jax"], "plans.json")) as g:
        assert json.load(f) == json.load(g)


def test_preprocess_reads_yaml_config(raw, tmp_path, capsys):
    """`--config` gives the raw and output folders (the port reads the YAML
    itself); the CT fingerprint's intensities drive the normalisation."""
    for tag in ("jax", "port"):
        (tmp_path / f"{tag}.yaml").write_text(
            f'# preprocessing config\nraw_data_dir: "{raw}/ct"\n'
            f'data_dir: "{tmp_path}/{tag}"\nseed: 3\n')
    for tag, mod in (("jax", jax_preprocess), ("port", preprocess)):
        mod.main(["--config", str(tmp_path / f"{tag}.yaml"), "--dataset-type", "ct",
                  "--num-processes", "1"])
    capsys.readouterr()
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    with pytest.raises(SystemExit):  # no config, no folders
        preprocess.main(["--config", str(tmp_path / "missing.yaml")])


def test_preprocess_rejects_bad_type_arguments(raw):
    with pytest.raises(SystemExit, match="--organ-list required"):
        preprocess.main(["--raw-dir", os.path.join(raw, "atlas"), "--out-dir", "unused",
                         "--dataset-type", "ct-organs"])


def _brats_named(root, rng):
    names = synthetic_cases.write_raw_cases(str(root), rng, (20, 22, 18), LPS, 2)
    with open(os.path.join(str(root), "README.txt"), "w") as f:
        f.write("not a case\n")
    os.rename(os.path.join(str(root), names[1], f"{names[1]}-t1c.nii.gz"),
              os.path.join(str(root), names[1], "t1c.nii.gz"))  # already renamed
    return names


def test_rename_data_matches_jax(tmp_path, capsys):
    names = _brats_named(tmp_path / "jax", np.random.default_rng(2))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    shutil.copytree(tmp_path / "jax", tmp_path / "dry")
    before = {n: sorted(os.listdir(tmp_path / "dry" / n)) for n in names}
    rename_data.main([str(tmp_path / "dry"), "--dry-run"])
    dry = capsys.readouterr().out
    assert {n: sorted(os.listdir(tmp_path / "dry" / n)) for n in names} == before
    assert dry.endswith("renamed 9 files\n")
    jax_rename_data.main([str(tmp_path / "jax")])
    want = capsys.readouterr().out
    rename_data.main([str(tmp_path / "port")])
    got = capsys.readouterr().out
    assert got.replace(str(tmp_path / "port"), "ROOT") == want.replace(str(tmp_path / "jax"), "ROOT")
    assert got.replace(str(tmp_path / "port"), "ROOT") == dry.replace(str(tmp_path / "dry"), "ROOT")
    for n in names:
        files = sorted(os.listdir(tmp_path / "port" / n))
        assert files == sorted(os.listdir(tmp_path / "jax" / n)) == [
            "seg.nii.gz", "t1c.nii.gz", "t1n.nii.gz", "t2f.nii.gz", "t2w.nii.gz"]
        for f in files:
            a, b = nifti.load(str(tmp_path / "port" / n / f)), nifti.load(str(tmp_path / "jax" / n / f))
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(a.affine, b.affine)
    assert rename_data.rename_dataset(str(tmp_path / "port")) == 0  # a second run: nothing left


def test_convert_split_matches_jax(tmp_path, capsys):
    txt = tmp_path / "cases.txt"
    txt.write_text("BraTS-GLI-00000-000\n\n  BraTS-GLI-00001-000  \nBraTS-GLI-00002-000")
    jax_convert_split.main([str(txt), str(tmp_path / "jax.pkl")])
    want = capsys.readouterr().out
    assert convert_split.main([str(txt), str(tmp_path / "port.pkl")]) is None
    got = capsys.readouterr().out
    assert got.replace("port.pkl", "X") == want.replace("jax.pkl", "X")
    with open(tmp_path / "port.pkl", "rb") as f, open(tmp_path / "jax.pkl", "rb") as g:
        assert_same(pickle.load(f), pickle.load(g))
    assert convert_split.txt_to_pkl(str(txt), str(tmp_path / "again.pkl")) == 3
