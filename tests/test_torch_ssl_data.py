"""The port's SSL data plumbing (`data/ssl_data.py`) against the JAX
package's on the same NIfTI files and seeds: datalists, intensity scaling,
the k-divisible foreground crop, the cached datasets and the crop loader's
batches, all equal (`np.array_equal`; the same host numpy in the same
order)."""

import json
import os

import numpy as np
import pytest

from waveformer_tpu.data import ssl_data as jsd
from waveformer_tpu_torch.data import ssl_data as tsd
from waveformer_tpu_torch.utils import nifti


def _ct_volume(shape, seed):
    """int16 HU: air at -1000 around a body ellipsoid of soft tissue with
    noise, as a CT scan holds."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*(np.linspace(-1, 1, s) for s in shape), indexing="ij"))
    radii = np.asarray([0.7, 0.6, 0.8])[:, None, None, None]
    body = ((grid / radii) ** 2).sum(0) <= 1.0
    vol = np.where(body, 40.0 + 60.0 * rng.standard_normal(shape), -1000.0)
    return vol.astype(np.int16)


@pytest.fixture(scope="module")
def datalist(tmp_path_factory):
    root = tmp_path_factory.mktemp("ssl_ct")
    os.makedirs(root / "imgs")
    # ct_3 is thinner than the ROI: padded with the odd voxel at the end
    for i, shape in enumerate([(30, 26, 20), (24, 28, 22), (20, 20, 34), (26, 22, 13)]):
        nifti.save(nifti.NiftiImage(data=_ct_volume(shape, i)), str(root / "imgs" / f"ct_{i}.nii.gz"))
    spec = {"training": [{"image": f"imgs/ct_{i}.nii.gz"} for i in range(2)]
            + ["imgs/ct_2.nii.gz"],
            "validation": [str(root / "imgs" / "ct_3.nii.gz")]}
    js = root / "dataset.json"
    js.write_text(json.dumps(spec))
    return str(js), str(root)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("key", ["training", "validation"])
@pytest.mark.parametrize("base", [None, "other"])
def test_datalist_matches_jax(datalist, key, base):
    js, root = datalist
    base_dir = os.path.join(root, base) if base else None
    got = tsd.load_decathlon_datalist(js, False, key, base_dir=base_dir)
    assert got == jsd.load_decathlon_datalist(js, False, key, base_dir=base_dir)
    assert all(set(e) == {"image"} for e in got)


@pytest.mark.parametrize("args,match", [((False, "test"), "not in"),
                                        ((True, "training"), "missing label")])
def test_datalist_errors_match_jax(datalist, args, match):
    for mod in (tsd, jsd):
        with pytest.raises(ValueError, match=match):
            mod.load_decathlon_datalist(datalist[0], *args)


@pytest.mark.parametrize("clip", [True, False])
def test_scale_intensity_range_matches_jax(clip):
    img = _ct_volume((12, 10, 8), 5) * 3
    args = (img, -1000.0, 1000.0, 0.0, 1.0, clip)
    assert _same(tsd.scale_intensity_range(*args), jsd.scale_intensity_range(*args))


@pytest.mark.parametrize("case", ["inside", "pads", "empty"])
def test_crop_foreground_matches_jax(case):
    vol = np.zeros((20, 18, 16), np.float32)
    if case == "inside":
        vol[5:11, 4:9, 6:10] = 1.0
    elif case == "pads":
        vol[1:19, 0:18, 2:15] = 0.5
    k = (8, 8, 8) if case != "pads" else (12, 12, 12)
    got = tsd.crop_foreground_k_divisible(vol, k)
    assert _same(got, jsd.crop_foreground_k_divisible(vol, k))
    assert all(s % kk == 0 for s, kk in zip(got.shape, k))


@pytest.mark.parametrize("cache", [dict(), dict(cache_rate=0.5), dict(smart_cache_num=2)])
def test_dataset_items_and_caches_match_jax(datalist, cache):
    js, _ = datalist
    items = jsd.load_decathlon_datalist(js, False, "training")
    items += jsd.load_decathlon_datalist(js, False, "validation")
    kw = dict(roi=(16, 16, 16), **cache)
    t, j = tsd.SSLVolumeDataset(items, **kw), jsd.SSLVolumeDataset(items, **kw)
    for epoch in range(3):
        assert t.cached_indices == j.cached_indices
        for i in range(len(items)):
            assert _same(t[i], j[i]), (epoch, i)
        t.advance()
        j.advance()
    with pytest.raises(ValueError, match="either"):
        tsd.SSLVolumeDataset(items, cache_rate=1.0, smart_cache_num=1)


@pytest.mark.parametrize("prefetch", [False, True])
def test_crop_loader_batches_match_jax(datalist, prefetch):
    js, _ = datalist
    items = jsd.load_decathlon_datalist(js, False, "training")
    kw = dict(batch_size=3, num_samples=2, num_steps=4, seed=9, prefetch=prefetch)
    got = list(tsd.SSLCropLoader(tsd.SSLVolumeDataset(items, roi=(16, 16, 16), cache_rate=1.0),
                                 **kw))
    want = list(jsd.SSLCropLoader(jsd.SSLVolumeDataset(items, roi=(16, 16, 16), cache_rate=1.0),
                                  **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == (3, 16, 16, 16, 1) and _same(g, w)


def test_crop_loader_reraises_worker_errors():
    ds = tsd.SSLVolumeDataset([{"image": "/nonexistent/x.nii.gz"}], roi=(16, 16, 16))
    with pytest.raises(FileNotFoundError):
        list(tsd.SSLCropLoader(ds, batch_size=1, num_steps=1))
