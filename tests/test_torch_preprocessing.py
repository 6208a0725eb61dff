"""The port's preprocessing (`waveformer_tpu_torch/data/preprocessing.py`)
and dataset variants against the JAX package's, held to exact equality.

Both packages run the same numpy/scipy calls, so every array is compared
with `np.array_equal` (and its dtype), and every properties dict key for
key after unpickling: any difference is a porting fault. The inputs are
seeded numpy volumes and small synthetic NIfTI trees (24-42 voxels an
edge): an LPS-oriented case, an axis-permuted one and a 1 × 1 × 3.5 mm one
(resampled along z on its own), a flat CT tree, a per-organ-mask tree.
Every pool here runs in-process except two: a 2-worker spawn pool on 2
cases against the JAX package's in-process run, and a pool whose worker
raises in `read_data`, which must end in `RuntimeError`.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from waveformer_tpu.data import dataset as jds
from waveformer_tpu.data import dataset_variants as jdv
from waveformer_tpu.data import preprocessing as jpp
from waveformer_tpu_torch.data import dataset as tds
from waveformer_tpu_torch.data import dataset_variants as tdv
from waveformer_tpu_torch.data import preprocessing as tpp
from waveformer_tpu_torch.utils import nifti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODALITIES = ("t1.nii.gz", "t2.nii.gz")
KINDS = ("mri", "mri-global", "ct", "ct-organs", "multi-input")
REGIONS = ((1, 2, 3), (2, 3), (3,))
# (name, raw (X, Y, Z) shape, affine) of the multi-modality tree: LPS
# (flipped X and Y, 1.1 × 0.9 × 1.3 mm), 1 × 1 × 3.5 mm (separate-z), and
# an axis-permuted affine
PERMUTED = np.array([[0.0, 0.0, 1.2, 0.0], [-1.0, 0.0, 0.0, 0.0],
                     [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
MRI_CASES = [
    ("case_lps", (30, 28, 26), np.diag([-1.1, -0.9, 1.3, 1.0])),
    ("case_aniso", (32, 30, 12), np.diag([1.0, 1.0, 3.5, 1.0])),
    ("case_perm", (28, 32, 24), PERMUTED),
]


def assert_same(got, want, path="value"):
    """Equal type, structure and content; arrays by dtype, shape and
    `np.array_equal`; dicts key for key, in the same order."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert np.array_equal(got, want), path
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def assert_same_tree(got_dir, want_dir):
    """Two artifact folders hold the same files, the same arrays in every
    `.npz` and the same properties in every `.pkl`."""
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    for f in sorted(os.listdir(want_dir)):
        g, w = os.path.join(got_dir, f), os.path.join(want_dir, f)
        if f.endswith(".npz"):
            with np.load(g) as zg, np.load(w) as zw:
                assert sorted(zg.files) == sorted(zw.files), f
                for k in zw.files:
                    assert_same(zg[k], zw[k], f"{f}:{k}")
        elif f.endswith(".pkl"):
            with open(g, "rb") as fg, open(w, "rb") as fw:
                assert_same(pickle.load(fg), pickle.load(fw), f)
        elif f.endswith(".npy"):
            assert_same(np.load(g), np.load(w), f)


def _save(path, data, affine):
    nifti.save(nifti.NiftiImage(data=data, affine=np.asarray(affine, np.float32)), str(path))


def _brain_case(case_dir, rng, shape, affine, seg_name="seg.nii.gz"):
    """Two modalities nonzero in an ellipsoid "brain" smaller than the
    volume (so the crop's corners lie outside the mask, and a zero hole
    inside it, which the mask fills), and labels 1-3 inside it."""
    os.makedirs(case_dir)
    c = [n // 2 for n in shape]
    grid = np.ogrid[tuple(slice(0, n) for n in shape)]
    inside = sum(((g - m) / (m - 2.5)) ** 2 for g, m in zip(grid, c)) < 1.0
    brain = np.where(inside, rng.standard_normal(shape) + 3.0, 0.0).astype(np.float32)
    brain[c[0] - 1:c[0] + 1, c[1] - 1:c[1] + 1, c[2]] = 0.0
    for i, mod in enumerate(MODALITIES):
        _save(os.path.join(case_dir, mod), brain * (1.0 + i) + (brain != 0) * i, affine)
    seg = np.zeros(shape, np.int8)
    seg[c[0] - 6:c[0] + 6, c[1] - 6:c[1] + 6, c[2] - 3:c[2] + 3] = 2
    seg[c[0] - 4:c[0] + 4, c[1] - 4:c[1] + 4, c[2] - 2:c[2] + 2] = 1
    seg[c[0] - 2:c[0] + 2, c[1] - 2:c[1] + 2, c[2] - 1:c[2] + 1] = 3
    if seg_name:
        _save(os.path.join(case_dir, seg_name), seg, affine)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The three raw trees: multi-modality (`mri/images/{case}`), flat CT
    (`ct/volume-{i}`, `segmentation-{i}`), per-organ masks (`atlas/{case}`)."""
    root = tmp_path_factory.mktemp("raw_trees")
    rng = np.random.default_rng(0)
    for name, shape, affine in MRI_CASES:
        _brain_case(os.path.join(root, "mri", "images", name), rng, shape, affine)
    os.makedirs(root / "ct")
    ct_affine = np.diag([0.8, 0.8, 2.5, 1.0])  # ratio 3.125: separate-z
    for i in range(2):
        shape = (30, 32, 20)
        vol = np.zeros(shape, np.float32)
        vol[2:-2, 2:-2, 1:-1] = rng.normal(40.0, 120.0, (26, 28, 18))
        seg = np.zeros(shape, np.int8)
        seg[8:20, 8:20, 6:14] = 1
        seg[12:16, 12:16, 8:11] = 2
        vol[seg > 0] += 60.0
        _save(root / "ct" / f"volume-{i}.nii.gz", vol, ct_affine)
        _save(root / "ct" / f"segmentation-{i}.nii.gz", seg, ct_affine)
    atlas_affine = np.diag([-1.0, 1.0, 3.0, 1.0])
    for name in ("BDMAP_00000001", "BDMAP_00000002"):
        segs = root / "atlas" / name / "segmentations"
        os.makedirs(segs)
        shape = (28, 28, 16)
        _save(root / "atlas" / name / "ct.nii.gz",
              rng.normal(30.0, 100.0, shape).astype(np.float32), atlas_affine)
        liver = np.zeros(shape, np.uint8)
        liver[4:14, 4:14, 4:10] = 1
        spleen = np.zeros(shape, np.uint8)
        spleen[10:20, 10:20, 6:12] = 1  # overlaps the liver: the later mask wins
        _save(segs / "liver.nii.gz", liver, atlas_affine)
        _save(segs / "spleen.nii.gz", spleen, atlas_affine)
    return str(root)


def make_preprocessor(mod, kind, root):
    """The dataset driver of `kind` from module `mod` (the JAX one or the
    port's), as `scripts/preprocess.py` builds it."""
    mri = dict(base_dir=os.path.join(root, "mri"), image_dir="images",
               data_filenames=MODALITIES, seg_filename="seg.nii.gz")
    if kind == "mri":
        return mod.MultiModalityPreprocessor(**mri)
    if kind == "mri-global":
        return mod.GlobalContextPreprocessor(**mri, global_size=(12, 14, 12))
    if kind == "ct":
        return mod.CTPreprocessor(base_dir=os.path.join(root, "ct"), foreground_classes=(1, 2))
    if kind == "ct-organs":
        return mod.OrganMaskPreprocessor(base_dir=os.path.join(root, "atlas"),
                                         seg_list=("liver.nii.gz", "spleen.nii.gz"))
    return mod.MultiInputRegionPreprocessor(**mri, regions=REGIONS)


@pytest.fixture(scope="module")
def plans(trees):
    """Each kind's JAX `run_plan`, and the CT intensity properties
    `scripts/preprocess.py` passes on (None for the other normalisations)."""
    out = {}
    for kind in KINDS:
        pp = make_preprocessor(jpp, kind, trees)
        plan = pp.run_plan()
        inten = None
        if pp.normalization == "ct":
            inten = {int(k): v for k, v in plan["intensities_per_channel"].items()}
        out[kind] = (plan, inten)
    return out


# --------------------------------------------------------------------------- #
# functions
# --------------------------------------------------------------------------- #


class TestCropping:
    def test_nonzero_mask_and_bbox(self, rng):
        data = np.zeros((2, 20, 24, 18), np.float32)
        data[0, 3:15, 5:20, 2:10] = rng.standard_normal((12, 15, 8))
        data[1, 4:16, 5:18, 4:12] = 1.0
        data[:, 8, 10, 6] = 0.0  # a hole: filled
        mask = tpp.create_nonzero_mask(data)
        assert_same(mask, jpp.create_nonzero_mask(data))
        assert mask[8, 10, 6]
        assert_same(tpp.get_bbox_from_mask(mask), jpp.get_bbox_from_mask(mask))
        empty = np.zeros((5, 6, 7), bool)
        assert_same(tpp.get_bbox_from_mask(empty), jpp.get_bbox_from_mask(empty))

    @pytest.mark.parametrize("ndim", [3, 4])
    def test_crop_to_bbox(self, rng, ndim):
        arr = rng.standard_normal((2, 10, 12, 9)[4 - ndim:])
        bbox = [[1, 8], [2, 12], [0, 5]]
        assert_same(tpp.crop_to_bbox(arr, bbox), jpp.crop_to_bbox(arr, bbox))

    @pytest.mark.parametrize("seg_kind", ["none", "3d", "4d"])
    def test_crop_to_nonzero(self, rng, seg_kind):
        data = np.zeros((3, 22, 20, 18), np.float32)
        data[:, 2:19, 3:17, 4:15] = rng.standard_normal((3, 17, 14, 11))
        data[:, 2:5, 3:6, 4:7] = 0.0  # a corner outside the mask after filling
        seg = None
        if seg_kind != "none":
            seg = rng.integers(0, 4, (22, 20, 18)).astype(np.int8)
            seg[data[0] == 0] = 0
            seg = seg[None] if seg_kind == "4d" else seg
        got, want = tpp.crop_to_nonzero(data, seg), jpp.crop_to_nonzero(data, seg)
        assert_same(got, want)
        if seg is not None:
            assert (got[1] == -1).any()


class TestNormalisation:
    @pytest.mark.parametrize("name", ["zscore", "zscore_mask", "ct", "rescale01", "rgb", "none"])
    def test_normaliser(self, rng, name):
        image = rng.normal(50.0, 30.0, (14, 16, 12)).astype(np.float32)
        seg = rng.integers(-1, 3, (14, 16, 12)).astype(np.int8)
        kwargs = {}
        if name == "zscore_mask":
            name, kwargs = "zscore", {"use_mask_for_norm": True}
        if name == "ct":
            kwargs = {"intensityproperties": {"percentile_00_5": 0.0, "percentile_99_5": 90.0,
                                              "mean": 48.0, "std": 25.0}}
        if name == "rgb":
            image = rng.integers(0, 256, image.shape).astype(np.uint8)
        got = tpp.DefaultPreprocessor._NORMALIZERS[name](**kwargs).run(image, seg)
        want = jpp.DefaultPreprocessor._NORMALIZERS[name](**kwargs).run(image, seg)
        assert_same(got, want)

    def test_rgb_rejects_out_of_range_and_ct_needs_properties(self):
        image = np.full((4, 4, 4), 300.0, np.float32)
        for mod in (tpp, jpp):
            with pytest.raises(ValueError, match="RGB normalization"):
                mod.RGBTo01Normalization().run(image, None)
            with pytest.raises(ValueError, match="intensity properties"):
                mod.CTNormalization()


class TestResampling:
    def test_compute_new_shape(self):
        for args in [((20, 30, 40), (1.0, 1.0, 1.0), (0.5, 1.5, 1.0)),
                     ((33, 17, 25), (3.5, 0.9, 1.1), (1.0, 1.0, 1.0))]:
            assert_same(tpp.compute_new_shape(*args), jpp.compute_new_shape(*args))

    @pytest.mark.parametrize("order", [0, 1, 3])
    @pytest.mark.parametrize("new_shape", [(17, 23, 11), (24, 30, 20), (13, 15, 21)])
    def test_resize_3d(self, rng, order, new_shape):
        vol = rng.standard_normal((17, 23, 11)).astype(np.float64)
        assert_same(tpp._resize_3d(vol, new_shape, order),
                    jpp._resize_3d(vol, new_shape, order))

    @pytest.mark.parametrize("case", ["isotropic", "separate_z", "separate_z_last_axis"])
    def test_data(self, rng, case):
        data = rng.standard_normal((2, 16, 20, 18)).astype(np.float32)
        spacing, new = {"isotropic": ((1.2, 0.8, 1.0), (1.0, 1.0, 1.0)),
                        "separate_z": ((3.5, 1.0, 1.0), (1.0, 1.0, 1.0)),
                        "separate_z_last_axis": ((0.9, 1.0, 4.0), (1.0, 1.0, 2.0))}[case]
        shape = tpp.compute_new_shape(data.shape[1:], spacing, new)
        got = tpp.resample_data_or_seg_to_shape(data, shape, spacing, new)
        assert got.shape == (2, *shape)
        assert_same(got, jpp.resample_data_or_seg_to_shape(data, shape, spacing, new))

    @pytest.mark.parametrize("spacing", [(1.3, 1.0, 0.7), (3.5, 1.0, 1.0)])
    def test_seg(self, rng, spacing):
        seg = np.zeros((1, 16, 20, 18), np.int8)
        seg[0, 3:12, 4:15, 5:13] = 2
        seg[0, 5:10, 6:12, 7:11] = 1
        seg[0, :2] = -1
        flat = np.full((1, 16, 20, 18), 3, np.int8)
        new = (1.0, 1.0, 1.0)
        shape = tpp.compute_new_shape(seg.shape[1:], spacing, new)
        for s in (seg, flat):
            got = tpp.resample_data_or_seg_to_shape(s, shape, spacing, new, is_seg=True, order=1)
            assert_same(got, jpp.resample_data_or_seg_to_shape(s, shape, spacing, new,
                                                               is_seg=True, order=1))


class TestForegroundSampling:
    def _seg(self, rng):
        seg = np.zeros((30, 34, 28), np.int8)
        seg[2:28, 3:30, 4:26] = 1  # ~15k voxels: the 1% rule above the 1000 floor
        seg[10:20, 10:20, 10:20] = 2
        seg[14:16, 14:16, 14:16] = 3  # fewer voxels than the floor
        return seg

    @pytest.mark.parametrize("ndim", [3, 4])
    @pytest.mark.parametrize("kw", [{}, {"max_per_class": 500, "min_per_class": 100, "seed": 7}])
    def test_classes(self, rng, ndim, kw):
        seg = self._seg(rng)
        seg = seg[None] if ndim == 4 else seg
        classes = (1, 2, 3, 4)  # 4 is absent: an empty (0, 4) array
        got = tpp.sample_foreground_locations(seg, classes, **kw)
        assert_same(got, jpp.sample_foreground_locations(seg, classes, **kw))
        assert got[4].shape == (0, 4)

    def test_regions(self, rng):
        seg = self._seg(rng)[None]
        regions = ((1, 2, 3), (2, 3), (3,), 2, (5, 6))
        got = tpp.sample_foreground_locations_regions(seg, regions)
        assert_same(got, jpp.sample_foreground_locations_regions(seg, regions))
        assert list(got) == [(1, 2, 3), (2, 3), 3, 2, (5, 6)]


def test_load_canonical_nifti_and_orientation_properties(trees):
    name, _, affine = MRI_CASES[0]
    path = os.path.join(trees, "mri", "images", name, "t1.nii.gz")
    (tcan, tsrc, tornt), (jcan, jsrc, jornt) = (tpp.load_canonical_nifti(path),
                                                jpp.load_canonical_nifti(path))
    assert_same(tcan.data, jcan.data)
    assert_same(np.asarray(tcan.affine), np.asarray(jcan.affine))
    assert_same(np.asarray(tsrc), np.asarray(jsrc))
    assert_same(np.asarray(tornt), np.asarray(jornt))
    np.testing.assert_array_equal(tsrc, np.asarray(affine, np.float32))
    assert_same(tpp._orientation_properties({"name": name}, tcan, tsrc, tornt),
                jpp._orientation_properties({"name": name}, jcan, jsrc, jornt))


# --------------------------------------------------------------------------- #
# the five dataset drivers
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", KINDS)
class TestPreprocessors:
    def test_read_data(self, trees, kind):
        tp, jp = make_preprocessor(tpp, kind, trees), make_preprocessor(jpp, kind, trees)
        cases = tp.get_iterable_list()
        assert cases == jp.get_iterable_list() and len(cases) >= 2
        for case in cases:
            assert_same(tp.read_data(case), jp.read_data(case), case)

    def test_run_case_npy(self, trees, plans, kind):
        tp, jp = make_preprocessor(tpp, kind, trees), make_preprocessor(jpp, kind, trees)
        inten = plans[kind][1]
        for case in tp.get_iterable_list():
            got = tp.run_case_npy(*tp.read_data(case), inten)
            assert_same(got, jp.run_case_npy(*jp.read_data(case), inten), case)
            if kind in ("mri", "mri-global", "multi-input"):
                assert (got[1] == -1).any()  # the crop's corners, outside the brain
            assert got[2]["class_locations"]

    def test_run_case_save(self, trees, plans, kind, tmp_path):
        tp, jp = make_preprocessor(tpp, kind, trees), make_preprocessor(jpp, kind, trees)
        inten = plans[kind][1]
        for case in tp.get_iterable_list():
            assert tp.run_case_save(case, str(tmp_path / "port"), inten) == case
            jp.run_case_save(case, str(tmp_path / "jax"), inten)
        assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))

    def test_run_plan(self, trees, plans, kind):
        got = make_preprocessor(tpp, kind, trees).run_plan()
        assert_same(got, plans[kind][0])
        assert got["n_cases_fingerprinted"] >= 2


def test_two_worker_pool_equals_jax_in_process(tmp_path):
    """The port's spawn pool (2 workers, 2 cases: an LPS one and a
    separate-z one) writes what the JAX package writes in-process."""
    rng = np.random.default_rng(4)
    for name, shape, affine in MRI_CASES[:2]:
        _brain_case(str(tmp_path / "raw" / "images" / name), rng, shape, affine)
    kw = dict(base_dir=str(tmp_path / "raw"), image_dir="images",
              data_filenames=MODALITIES, seg_filename="seg.nii.gz")
    done = tpp.MultiModalityPreprocessor(**kw).run(str(tmp_path / "port"), num_processes=2)
    assert done == ["case_aniso", "case_lps"]
    jpp.MultiModalityPreprocessor(**kw).run(str(tmp_path / "jax"), num_processes=1)
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_worker_failure_raises_runtime_error(tmp_path):
    """A case whose `read_data` raises in a worker (a missing modality file)
    ends the pool with `RuntimeError`; nothing is killed."""
    rng = np.random.default_rng(5)
    affine = np.eye(4)
    _brain_case(str(tmp_path / "raw" / "images" / "good"), rng, (24, 24, 24), affine)
    _brain_case(str(tmp_path / "raw" / "images" / "bad"), rng, (24, 24, 24), affine)
    os.remove(tmp_path / "raw" / "images" / "bad" / MODALITIES[1])
    pp = tpp.MultiModalityPreprocessor(base_dir=str(tmp_path / "raw"), image_dir="images",
                                       data_filenames=MODALITIES)
    with pytest.raises(RuntimeError, match="preprocessing worker failed") as info:
        pp.run(str(tmp_path / "out"), num_processes=2)
    assert isinstance(info.value.__cause__, FileNotFoundError)


# --------------------------------------------------------------------------- #
# dataset variants
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def fullres(trees, tmp_path_factory):
    """The multi-modality tree preprocessed plainly and with the global
    context pair (by the port; the tests above hold it equal to JAX)."""
    root = tmp_path_factory.mktemp("fullres")
    out = {}
    for kind in ("mri", "mri-global"):
        out[kind] = str(root / kind)
        make_preprocessor(tpp, kind, trees).run(out[kind], num_processes=1)
    return out


@pytest.mark.parametrize("source", ["npz", "npy", "derived"])
def test_global_context_dataset(fullres, source):
    folder = fullres["mri" if source == "derived" else "mri-global"]
    unpack = source == "npy"
    names = [c for c, _, _ in MRI_CASES]
    tbase = tds.MedicalDataset(folder, names, unpack=unpack, num_processes=1)
    jbase = jds.MedicalDataset(folder, names, unpack=unpack, num_processes=1)
    if unpack:
        assert os.path.exists(os.path.join(folder, names[0] + "_data_global.npy"))
    tset = tdv.GlobalContextDataset(tbase, global_shape=(10, 12, 8))
    jset = jdv.GlobalContextDataset(jbase, global_shape=(10, 12, 8))
    assert len(tset) == len(jset) == 3 and tset.case_names == names
    assert tset.data_dir == folder
    for i in range(3):
        got, want = tset[i], jset[i]
        assert_same(np.asarray(got["data_global"]), np.asarray(want["data_global"]))
        assert_same(np.asarray(got["data"]), np.asarray(want["data"]))
        assert tset[i]["data_global"] is got["data_global"]  # memoised
    if source == "derived":
        assert got["data_global"].shape == (2, 10, 12, 8)
    else:
        assert got["data_global"].shape == (2, 12, 14, 12)


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (2.0, 0.5, 1.5)])
def test_signed_distance_and_edge_maps(rng, spacing):
    seg = np.zeros((18, 20, 16), np.int8)
    seg[4:12, 5:15, 3:11] = 1
    seg[7:10, 8:12, 5:8] = 2
    for mask in (seg == 1, seg > 0, np.zeros_like(seg, bool), np.ones_like(seg, bool)):
        for normalize in (True, False):
            assert_same(tdv.signed_distance_map(mask, spacing, normalize),
                        jdv.signed_distance_map(mask, spacing, normalize))
    for s in (seg, np.zeros_like(seg), rng.integers(0, 2, seg.shape)):
        assert_same(tdv.edge_map(s), jdv.edge_map(s))


def test_sdm_edge_dataset(fullres):
    names = [c for c, _, _ in MRI_CASES]
    tset = tdv.SDMEdgeDataset(tds.MedicalDataset(fullres["mri"], names, unpack=False))
    jset = jdv.SDMEdgeDataset(jds.MedicalDataset(fullres["mri"], names, unpack=False))
    assert len(tset) == 3 and tset.case_names == names and tset.data_dir == fullres["mri"]
    for name in names:
        got, want = tset[name], jset[name]
        assert got["seg_sdm"].shape[0] == 3 and got["seg_edge"].shape[0] == 1
        for key in ("seg_sdm", "seg_edge", "seg", "data"):
            assert_same(np.asarray(got[key]), np.asarray(want[key]), key)


def test_host_modules_import_no_torch():
    """The five host modules of the front end, and the SSL data module,
    load no torch (nor JAX), so the preprocessing pool's spawn workers start
    without it."""
    code = (
        "import sys\n"
        "import waveformer_tpu_torch.data.ssl_data\n"
        "import waveformer_tpu_torch.data.preprocessing\n"
        "import waveformer_tpu_torch.data.dataset_variants\n"
        "import waveformer_tpu_torch.scripts.rename_data\n"
        "import waveformer_tpu_torch.scripts.convert_split\n"
        "import waveformer_tpu_torch.scripts.preprocess\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'jax', 'waveformer_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
