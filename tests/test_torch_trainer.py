"""The port's `Trainer`, checkpoints and TensorBoard writer, mirroring
`tests/test_trainer.py` on the CPU: two epochs with validation, resume from a
periodic state, the checkpoint helpers, label modes, NaN filtering of the
validation dice, the full-volume and `validation_single_gpu` hooks, and
`SummaryWriter` records byte-equal to the JAX package's for the same
scalars under one fixed clock.
"""

import glob
import json
import os
import pickle
import struct

import numpy as np
import pytest
import torch

from waveformer_tpu.utils import logger as jlogger
from waveformer_tpu_torch.data.dataset import MedicalDataset
from waveformer_tpu_torch.models import create_waveformer
from waveformer_tpu_torch.training.checkpoint import (
    CheckpointManager,
    load_params_npz,
    save_new_model_and_delete_last,
    save_params_npz,
)
from waveformer_tpu_torch.training.state import TrainState, make_optimizer
from waveformer_tpu_torch.training.trainer import Trainer, step_seed
from waveformer_tpu_torch.utils import logger as tlogger
from waveformer_tpu_torch.utils.logger import SummaryWriter, crc32c, setup_logging

TINY = dict(img_size=(16, 16, 16), patch_size=2, in_chans=1, out_chans=4,
            depths=(1, 1, 1, 1), embed_dims=(4, 8, 16, 32), num_heads=(1, 2, 4, 4),
            decom_levels=(3, 2, 1, 0), drop_path_rate=0.0)

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the tier-1 run puts six pytest
    workers on the cores, and torch's thread pools then contend (these small
    CPU steps ran 10-50× slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    """Synthetic preprocessed cases written directly as npz/pkl (the JAX
    test's tree)."""
    out = tmp_path_factory.mktemp("fullres")
    rng = np.random.default_rng(0)
    for i in range(3):
        shape = (40, 40, 40)
        data = rng.standard_normal((1, *shape)).astype(np.float32)
        seg = np.zeros((1, *shape), np.int8)
        seg[0, 10:25, 10:25, 10:25] = 1
        seg[0, 15:20, 15:20, 15:20] = 3
        data[0][seg[0] > 0] += 2.0  # learnable signal
        np.savez_compressed(out / f"case_{i}.npz", data=data, seg=seg)
        props = {
            "spacing": [1, 1, 1],
            "class_locations": {1: np.argwhere(seg == 1)[:500], 3: np.argwhere(seg == 3)[:500]},
            "shape_before_cropping": shape,
            "bbox_used_for_cropping": [[0, 40], [0, 40], [0, 40]],
            "shape_after_cropping_before_resample": shape,
        }
        with open(out / f"case_{i}.pkl", "wb") as f:
            pickle.dump(props, f)
    return str(out)


def _tiny_model(**kw):
    return create_waveformer(dict(TINY, **kw), device="cpu", seed=0)


def _trainer(tmp_path, **kw):
    args = dict(max_epochs=1, batch_size=1, patch_size=(16, 16, 16),
                logdir=str(tmp_path / "logs"), num_workers=0)
    args.update(kw)
    return Trainer(_tiny_model(), **args)


class TestTrainerLoop:
    def test_two_epochs_with_validation(self, tiny_dataset, tmp_path):
        ds = MedicalDataset(tiny_dataset, [f"case_{i}" for i in range(3)], num_processes=1)
        logdir = str(tmp_path / "logs")
        trainer = Trainer(_tiny_model(), max_epochs=2, batch_size=2, val_every=1,
                          num_steps_per_epoch=3, val_patches_per_epoch=2,
                          patch_size=(16, 16, 16), lr=1e-3, logdir=logdir, num_workers=0,
                          seed=0)
        best = trainer.train(ds, ds)
        assert 0.0 <= best <= 1.0
        assert trainer.global_step == trainer.state.step == 6
        assert glob.glob(os.path.join(logdir, "model", "final_model_*.npz"))
        if best > 0:
            assert glob.glob(os.path.join(logdir, "model", "best_model_*.npz"))
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            rows = [json.loads(l) for l in f]
        tags = {r["tag"] for r in rows}
        assert {"training_loss", "epoch_loss", "mean_dice", "lr"} <= tags
        losses = [r["value"] for r in rows if r["tag"] == "training_loss"]
        assert [r["step"] for r in rows if r["tag"] == "training_loss"] == list(range(6))
        assert np.isfinite(losses).all()
        assert len(trainer.epoch_times) == 2 and all(n == 3 for n, _, _ in trainer.epoch_times)
        assert not trainer.model.training  # left in eval mode
        # the final checkpoint is the masters in the JAX package's format
        from waveformer_tpu_torch.utils.jax_params import state_dict_from_jax

        path = glob.glob(os.path.join(logdir, "model", "final_model_*.npz"))[0]
        sd = state_dict_from_jax(load_params_npz(path), TINY["depths"])
        for n, m in trainer.state.params.items():
            assert torch.equal(sd[n], m.detach())
        # load_params puts such a file into a fresh trainer's module, and into
        # a training one's masters and module
        fresh = _trainer(tmp_path / "fresh")
        fresh.load_params(path)
        trainer.state.params[next(iter(sd))].data.zero_()
        trainer.load_params(path)
        for t in (fresh, trainer):
            for n, p in t.model.named_parameters():
                assert torch.equal(p.detach(), sd[n]), n

    def test_resume_from_periodic(self, tiny_dataset, tmp_path):
        ds = MedicalDataset(tiny_dataset, ["case_0", "case_1"], unpack=False)
        logdir = str(tmp_path / "logs2")

        def mk(max_epochs):
            return Trainer(_tiny_model(), max_epochs=max_epochs, batch_size=2, val_every=100,
                           num_steps_per_epoch=2, patch_size=(16, 16, 16), logdir=logdir,
                           num_workers=0, seed=0)

        t1 = mk(1)
        t1.train(ds, ds)
        t1.ckpt.save_state(t1.state, 0)  # periodic state at epoch 0
        step_after = t1.state.step
        saved = {k: v.detach().clone() for k, v in t1.state.params.items()}
        mu1, nu1 = (dict((k, v.clone()) for k, v in m.items()) for m in t1.state.moments())

        t2 = mk(2)
        # resumed: started at epoch 1, so total steps = step_after + 2
        t2.train(ds, ds)
        assert t2.state.step == step_after + 2 and t2.global_step == step_after + 2
        assert len(t2.epoch_times) == 1

        # the restored state is the saved one, moments and masters alike
        t3 = mk(1)
        state = TrainState.create(
            {k: torch.zeros_like(v) for k, v in saved.items()}, make_optimizer())
        t3.ckpt.load_state(state)
        mu3, nu3 = state.moments()
        assert state.step == step_after
        for k in saved:
            assert torch.equal(state.params[k], saved[k])
            assert torch.equal(mu3[k], mu1[k]) and torch.equal(nu3[k], nu1[k])


class TestFullVolumeValidation:
    def test_hook_runs_and_logs(self, tiny_dataset, tmp_path):
        ds = MedicalDataset(tiny_dataset, [f"case_{i}" for i in range(3)], unpack=False)
        logdir = str(tmp_path / "logs_fv")
        trainer = Trainer(_tiny_model(), max_epochs=1, batch_size=2, val_every=1,
                          num_steps_per_epoch=2, val_patches_per_epoch=2,
                          patch_size=(16, 16, 16), logdir=logdir, num_workers=0, seed=0,
                          full_val_every=1, full_val_cases=2)
        trainer.train(ds, ds)
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            tags = {json.loads(l)["tag"] for l in f}
        assert {"full_tc_dice", "full_wt_dice", "full_et_dice"} <= tags

    def test_full_volume_dice_is_exact_on_perfect_model(self, tmp_path):
        out = tmp_path / "fullres"
        out.mkdir()
        rng = np.random.default_rng(1)
        shape = (24, 20, 28)  # not a multiple of the patch on purpose
        seg = np.zeros((1, *shape), np.int8)
        seg[0, 4:12, 5:13, 6:14] = 1
        seg[0, 7:10, 7:10, 8:11] = 3
        data = rng.standard_normal((1, *shape)).astype(np.float32)
        np.savez_compressed(out / "case_0.npz", data=data, seg=seg)
        with open(out / "case_0.pkl", "wb") as f:
            pickle.dump({"spacing": [1, 1, 1]}, f)
        ds = MedicalDataset(str(out), ["case_0"], unpack=False)

        t = _trainer(tmp_path, full_val_cases=1)
        d = t._case_dice(np.asarray(seg[0]), np.asarray(seg[0]))
        np.testing.assert_allclose(d, [1.0, 1.0, 1.0], atol=1e-6)

        class ZeroModel(torch.nn.Module):
            """Always class 0: dice 0 for present classes, never NaN."""

            def forward(self, patches):
                logits = torch.zeros((*patches.shape[:-1], 4))
                logits[..., 0] = 1.0
                return logits

        t.model = ZeroModel()
        t.writer = None
        per_class = t.full_volume_validation(ds)
        np.testing.assert_allclose(per_class, [0.0, 0.0, 0.0], atol=1e-6)


class TestCheckpointHelpers:
    def test_save_delete_last(self, tmp_path, rng):
        params = {"params": {"w": rng.standard_normal((3, 3)).astype(np.float32)}}
        d = str(tmp_path)
        save_new_model_and_delete_last(params, os.path.join(d, "best_model_0.5.npz"),
                                       "best_model", metadata={"epoch": 1})
        save_new_model_and_delete_last(params, os.path.join(d, "best_model_0.7.npz"),
                                       "best_model", metadata={"epoch": 2})
        hits = glob.glob(os.path.join(d, "best_model_*"))
        assert sorted(os.path.basename(h) for h in hits) == ["best_model_0.7.npz",
                                                             "best_model_0.7.npz.json"]

    def test_params_npz_roundtrip(self, tmp_path, rng):
        params = {"params": {"layer": {"kernel": rng.standard_normal((4, 2)).astype(np.float32)},
                             "bias": np.zeros(2, np.float32)}}
        p = str(tmp_path / "m.npz")
        save_params_npz(params, p, metadata={"epoch": 3})
        back = load_params_npz(p)
        np.testing.assert_array_equal(back["params"]["layer"]["kernel"],
                                      params["params"]["layer"]["kernel"])
        assert json.load(open(p + ".json"))["epoch"] == 3

    def test_manager_periodic_prune_and_latest(self, tmp_path):
        state = TrainState.create({"w": torch.zeros(2, 2)}, make_optimizer())
        cm = CheckpointManager(str(tmp_path / "ck"), keep_periodic=2)
        for e in (99, 199, 299):
            cm.save_state(state, e, extra={"mean_dice": 0.5})
        ckpts = [c for c in glob.glob(str(tmp_path / "ck" / "state_epoch_*"))
                 if not c.endswith(".json")]
        assert sorted(os.path.basename(c) for c in ckpts) == ["state_epoch_00199",
                                                              "state_epoch_00299"]
        assert not os.path.exists(str(tmp_path / "ck" / "state_epoch_00099.json"))
        path, epoch = cm.latest_checkpoint()
        assert epoch == 299
        assert json.load(open(path + ".json")) == {"epoch": 299, "mean_dice": 0.5}
        restored = cm.load_state(state, path)
        assert restored.step == 0
        assert CheckpointManager(str(tmp_path / "empty")).latest_checkpoint() is None
        with pytest.raises(FileNotFoundError):
            CheckpointManager(str(tmp_path / "empty")).load_state(state)


class TestSummaryWriter:
    def test_tfevents_record_framing(self, tmp_path):
        w = SummaryWriter(str(tmp_path))
        w.add_scalar("loss", 0.5, 1)
        w.close()
        events = glob.glob(str(tmp_path / "events.out.tfevents.*"))
        assert events
        raw = open(events[0], "rb").read()
        ln = struct.unpack("<Q", raw[:8])[0]
        assert 0 < ln < 200
        assert b"brain.Event:2" in raw[12:12 + ln]
        off = 12 + ln + 4
        ln2 = struct.unpack("<Q", raw[off:off + 8])[0]
        assert b"loss" in raw[off + 12:off + 12 + ln2]

    def test_records_byte_equal_to_jax(self, tmp_path, monkeypatch):
        clock = lambda: 1700000000.25
        monkeypatch.setattr(tlogger.time, "time", clock)
        monkeypatch.setattr(jlogger.time, "time", clock)
        scalars = [("training_loss", 2.5, 0), ("lr", 1e-4, 3), ("mean_dice", 0.123456789, 12),
                   ("tc_dice", float("nan"), 7), ("epoch_loss", -1.25, 250000)]
        raw = {}
        for name, mod in (("jax", jlogger), ("port", tlogger)):
            d = tmp_path / name
            w = mod.SummaryWriter(str(d))
            for tag, v, s in scalars:
                w.add_scalar(tag, v, s)
            w.add_scalars({"a": 1.0, "b": 2.0}, 5)
            w.close()
            (events,) = glob.glob(str(d / "events.out.tfevents.*"))
            raw[name] = (open(events, "rb").read(), open(d / "metrics.jsonl").read())
        assert raw["port"][0] == raw["jax"][0]
        assert raw["port"][1] == raw["jax"][1]

    def test_crc32c_known_vector(self):
        assert crc32c(b"\x00" * 32) == 0x8A9136AA
        assert crc32c(b"123456789") == jlogger.crc32c(b"123456789")

    def test_logger_levels(self, tmp_path, capsys):
        log_file = str(tmp_path / "t.log")
        lg = setup_logging(log_file=log_file, file_level="debug", console_level="error")
        lg.debug("to-file-only")
        lg.error("to-both")
        out = capsys.readouterr().out
        assert "to-both" in out and "to-file-only" not in out
        assert "to-file-only" in open(log_file).read()


class TestLabelModes:
    def test_multiclass_conversion(self, tmp_path):
        t = _trainer(tmp_path, label_mode="multiclass", num_classes=4)
        lab = torch.tensor([[[[[0], [1]], [[2], [3]]]]], dtype=torch.int32)
        out = t.convert_labels(lab).numpy()
        assert out.shape[1] == 3  # classes 1..3
        assert out[0, 0].sum() == 1 and out[0, 2].sum() == 1

    def test_brats_conversion_default(self, tmp_path):
        t = _trainer(tmp_path)
        out = t.convert_labels(torch.tensor([[[[[3]]]]], dtype=torch.int32)).numpy()
        np.testing.assert_array_equal(out[0, :, 0, 0, 0], [1, 1, 1])
        out = t.convert_labels(torch.tensor([[[[[2]]]]], dtype=torch.int32)).numpy()
        np.testing.assert_array_equal(out[0, :, 0, 0, 0], [0, 1, 0])


class TestValidationDiceSemantics:
    def test_nan_filtering(self, tmp_path):
        t = _trainer(tmp_path, label_mode="multiclass", num_classes=4)
        vals = [np.array([[0.8, np.nan, np.nan]]), np.array([[0.6, 0.4, np.nan]]),
                np.array([[0.7, 0.2, np.nan]])]
        t.validation_step = lambda p, b: vals.pop(0)
        t._device_batch = lambda b: b
        t.state = type("S", (), {"params": None})()
        out = t._validate([1, 2, 3])
        np.testing.assert_allclose(out[0], 0.7, atol=1e-6)
        np.testing.assert_allclose(out[1], 0.3, atol=1e-6)  # mean of 0.4, 0.2
        assert out[2] == 0.0  # all-NaN class scores 0, not 1

    def test_validation_step_emits_nan_for_absent_class(self, rng, tmp_path):
        t = _trainer(tmp_path, label_mode="multiclass", num_classes=4)
        seg = np.zeros((1, 16, 16, 16, 1), np.int8)
        seg[0, 2:6, 2:6, 2:6] = 1  # only class 1 present
        batch = {"data": torch.from_numpy(rng.standard_normal((1, 16, 16, 16, 1))
                                          .astype(np.float32)),
                 "seg": torch.from_numpy(seg)}
        d = t.validation_step(None, batch)
        assert d.shape == (1, 3)
        assert not np.isnan(d[0, 0])
        # a class absent from the truth is NaN exactly where the prediction
        # lacks it too
        pred = torch.argmax(t._eval_step(batch["data"]), dim=-1).numpy()
        for c in (2, 3):
            assert np.isnan(d[0, c - 1]) == (not (pred == c).any())


class TestValidationSingleGpu:
    class FakeDS:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            return {"i": i}

    def test_vector_outputs_nan_aware_mean(self, tmp_path):
        t = _trainer(tmp_path, resume=False)
        outs = iter([np.array([0.8, np.nan, 0.6]), np.array([0.6, np.nan, np.nan]),
                     np.array([np.nan, np.nan, 0.2])])
        means, all_outputs = t.validation_single_gpu(self.FakeDS(),
                                                     predict_case=lambda item: next(outs))
        np.testing.assert_allclose(means, [0.7, 0.0, 0.4])
        assert all_outputs.shape == (3, 3)

    def test_scalar_outputs(self, tmp_path):
        t = _trainer(tmp_path, resume=False)
        vals = iter([0.5, np.nan, 0.9])
        mean, all_outputs = t.validation_single_gpu(self.FakeDS(),
                                                    predict_case=lambda item: next(vals))
        assert mean == pytest.approx(0.7)
        assert all_outputs.shape == (3,)

    def test_default_hook_runs_inference(self, tiny_dataset, tmp_path):
        t = _trainer(tmp_path, resume=False)
        ds = MedicalDataset(tiny_dataset, ["case_0"], unpack=False)
        means, all_outputs = t.validation_single_gpu(ds)
        assert all_outputs.shape == (1, t.num_classes - 1)
        assert np.isfinite(np.asarray(means)).all()


def test_step_seed_folds_the_step():
    seeds = {step_seed(42, s) for s in range(100)}
    assert len(seeds) == 100 and all(0 <= s < 2**63 for s in seeds)
    assert step_seed(42, 7) == step_seed(42, 7) != step_seed(43, 7)


def test_upload_is_channels_last_and_typed(tmp_path):
    t = _trainer(tmp_path)
    b = t._device_batch({"data": np.zeros((2, 4, 4, 4, 1), np.float64),
                         "seg": np.ones((2, 4, 4, 4, 1), np.float32)})
    assert b["data"].dtype == torch.float32 and b["seg"].dtype == torch.int32
    assert b["data"].shape == (2, 4, 4, 4, 1)


class TestBf16Masters:
    """A bf16 trainer's fp32 masters are the fp32 weights it was built or
    loaded from, not their bf16 rounding (JAX keeps fp32 params)."""

    def test_init_state_keeps_fp32_weights(self, tmp_path):
        t = _trainer(tmp_path, compute_dtype=torch.bfloat16)
        state = t._init_state()
        want = create_waveformer(TINY, device="cpu", seed=0, dtype=torch.float32)
        assert t.model.compute_dtype == torch.bfloat16
        for n, p in want.named_parameters():
            assert state.params[n].dtype == torch.float32
            assert torch.equal(state.params[n], p.detach()), n
        # the relative-position tables stay fp32 in the module: their own masters
        tables = [n for n, p in t.model.named_parameters() if p.dtype == torch.float32]
        assert tables and all(n.endswith("relative_position_bias_table") for n in tables)
        assert all(state.params[n] is dict(t.model.named_parameters())[n] for n in tables)

    def test_loaded_checkpoint_becomes_the_masters(self, tiny_dataset, tmp_path):
        from waveformer_tpu_torch.tools.synthetic_cases import write_checkpoint
        from waveformer_tpu_torch.utils.jax_params import state_dict_from_jax

        path = str(tmp_path / "ckpt.npz")
        write_checkpoint(path, TINY, seed=3)
        sd = state_dict_from_jax(load_params_npz(path), TINY["depths"])
        assert any(not torch.equal(v, v.to(torch.bfloat16).float()) for v in sd.values())
        ds = MedicalDataset(tiny_dataset, ["case_0"], unpack=False)
        t = _trainer(tmp_path, max_epochs=0, compute_dtype=torch.bfloat16, resume=False)
        t.load_params(path)
        t.train(ds, ds)  # no epoch: the masters are taken and the module cast
        assert t.model.compute_dtype == torch.bfloat16
        for n, m in t.state.params.items():
            assert torch.equal(m, sd[n]), n
        for n, p in t.model.named_parameters():
            assert torch.equal(p, sd[n].to(p.dtype)), n

    def test_ssl_trainer_keeps_fp32_weights(self, tmp_path):
        from waveformer_tpu_torch.models.ssl import create_ssl_vit
        from waveformer_tpu_torch.training.ssl import SSLTrainer

        kw = dict(img_size=(16, 16, 16), patch_size=8, in_channels=1, hidden_size=16,
                  mlp_dim=32, num_layers=1, num_heads=2, projection_size=8)
        model = create_ssl_vit(device="cpu", seed=4, **kw)
        t = SSLTrainer(model, logdir=str(tmp_path), compute_dtype=torch.bfloat16)
        state = t._init_state()
        want = create_ssl_vit(device="cpu", seed=4, **kw)
        assert model.compute_dtype == torch.bfloat16
        for n, p in want.named_parameters():
            assert state.params[n].dtype == torch.float32
            assert torch.equal(state.params[n], p.detach()), n
            assert torch.equal(dict(model.named_parameters())[n], p.detach().to(torch.bfloat16))
