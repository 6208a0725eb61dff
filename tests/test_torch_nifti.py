"""The port's NIfTI reader/writer and orientation helpers against the JAX
package's: files written by either load in the other with the same data,
affine and spacing (`.nii` and `.nii.gz`; uint8, int16, float32), and the
orientation helpers agree exactly over the 48 axis permutations and flips.
"""

import itertools

import numpy as np
import pytest

from waveformer_tpu.utils import nifti as jn
from waveformer_tpu_torch.utils import nifti as tn


def _affine(perm, signs, spacing=(1.2, 0.8, 2.5), offset=(10.0, -4.0, 7.5)):
    """Voxel axis j along world axis perm[j], direction signs[j]."""
    a = np.eye(4)
    a[:3, :3] = 0.0
    for j, (w, s) in enumerate(zip(perm, signs)):
        a[w, j] = s * spacing[j]
    a[:3, 3] = offset
    return a.astype(np.float32)


ORIENTATIONS = [(p, s) for p in itertools.permutations(range(3))
                for s in itertools.product((1, -1), repeat=3)]


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_cross_load(tmp_path, suffix, dtype, writer):
    rng = np.random.default_rng(5)
    data = (rng.standard_normal((7, 5, 6)) * 40).astype(dtype)
    affine = _affine((1, 0, 2), (-1, 1, 1))
    path = str(tmp_path / f"img{suffix}")
    save, load = (tn.save, jn.load) if writer == "port" else (jn.save, tn.load)
    img_cls = tn.NiftiImage if writer == "port" else jn.NiftiImage
    save(img_cls(data=data, affine=affine), path)
    got = load(path)
    other = (tn.load if writer == "port" else jn.load)(path)
    assert got.data.dtype == data.dtype and got.data.shape == data.shape
    np.testing.assert_array_equal(got.data, data)
    np.testing.assert_array_equal(got.affine, affine)
    assert got.spacing == other.spacing == img_cls(data=data, affine=affine).spacing
    np.testing.assert_array_equal(other.data, got.data)
    with open(path, "rb") as f:
        written = f.read()
    alt = str(tmp_path / f"alt{suffix}")
    (jn.save if writer == "port" else tn.save)(
        (jn.NiftiImage if writer == "port" else tn.NiftiImage)(data=data, affine=affine), alt)
    if suffix == ".nii":  # the same bytes from both writers
        with open(alt, "rb") as f:
            assert f.read() == written


def test_qform_affine_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(10):
        q = rng.standard_normal(3) * 0.4
        offset = rng.standard_normal(3) * 10
        pixdim = [rng.choice([-1.0, 1.0, 0.0]), *rng.uniform(0.5, 3.0, 3), 1, 1, 1, 1]
        np.testing.assert_array_equal(tn._qform_to_affine(q, offset, pixdim),
                                      jn._qform_to_affine(q, offset, pixdim))


@pytest.mark.parametrize("perm,signs", ORIENTATIONS)
def test_orientation_helpers_match_jax(perm, signs):
    affine = _affine(perm, signs)
    data = np.random.default_rng(1).integers(0, 4, (6, 7, 5)).astype(np.uint8)
    ornt = tn.io_orientation(affine)
    np.testing.assert_array_equal(ornt, jn.io_orientation(affine))
    np.testing.assert_array_equal(tn.inverse_orientation(ornt), jn.inverse_orientation(ornt))
    np.testing.assert_array_equal(tn.apply_orientation(data, ornt),
                                  jn.apply_orientation(data, ornt))
    can, ornt_t = tn.as_canonical(tn.NiftiImage(data=data, affine=affine))
    jcan, ornt_j = jn.as_canonical(jn.NiftiImage(data=data, affine=affine))
    np.testing.assert_array_equal(ornt_t, ornt_j)
    np.testing.assert_array_equal(can.data, jcan.data)
    np.testing.assert_array_equal(can.affine, jcan.affine)
    np.testing.assert_array_equal(tn.orientation_affine(ornt, can.data.shape),
                                  jn.orientation_affine(ornt, jcan.data.shape))
    back = tn.undo_canonical(can.data, ornt)
    np.testing.assert_array_equal(back, jn.undo_canonical(jcan.data, ornt_j))
    np.testing.assert_array_equal(back, data)
