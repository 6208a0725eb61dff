"""SwinUNETR-V2 in the port against the benchmark's plain reference.

The system (`models/swin_unetr.py`, built by `models.create_model`) and the
float32 reference (`port_bench/reference/swin_unetr.py`, MONAI's equations
in plain PyTorch) on seeded random weights at 32³: stages 1-2 pad 16³ and
8³ to 21³ and 14³ and shift, stages 3-4 take 4³ and 2³ windows with the
`[:n, :n]` index and no shift. One state dict loads into both; their fp32
forwards and one training step's loss and gradients agree; the shift
labels are MONAI's `compute_mask`; a shifted block without its labels and
the flat window merge each fail the forward comparison. The masked plain
composition and its backward are held against float64.
"""

import numpy as np
import pytest
import torch

from port_bench.archs import swin_unetr as arch
from port_bench.reference import swin_unetr as ref
from port_bench.reference.train import dice_ce
from waveformer_tpu_torch.config import NetworkConfig, TransformerConfig
from waveformer_tpu_torch.models import create_model
from waveformer_tpu_torch.models import swin_unetr as su
from waveformer_tpu_torch.models.attention import WindowAttention
from waveformer_tpu_torch.ops import attention_cuda as ac
from waveformer_tpu_torch.ops import window as win
from waveformer_tpu_torch.training import losses as tl
from waveformer_tpu_torch.training import state as tstate

CASES = [(1, False, 1), (2, True, 2)]  # (input channels, use_v2, batch)


def _network(cin, v2):
    return {"img_size": [32, 32, 32], "in_channels": cin, "out_channels": 3,
            "feature_size": 24, "depths": [2, 2, 2, 2], "num_heads": [3, 6, 12, 24],
            "window_size": 7, "use_v2": v2}


def _pair(cin, v2, seed=5):
    """(system, reference, state dict) in fp32 on the CPU."""
    net = _network(cin, v2)
    sd = arch.make_state_dict(net, seed, "cpu")
    cfg = NetworkConfig(model_type="SwinUNETR", in_channels=cin, out_channels=3,
                        img_size=(32, 32, 32), feature_size=24, use_v2=v2,
                        transformer=TransformerConfig(drop_path_rate=0.0))
    system = create_model(cfg, device="cpu")
    system.load_state_dict(sd, strict=True)
    reference = ref.build(net, "cpu")
    reference.load_state_dict(sd, strict=True)
    return system, reference.eval(), sd


def _x(cin, batch, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 32, 32, 32, cin, generator=g)


def _gap(got, want):
    """Largest difference over the logits' largest magnitude."""
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(autouse=True)
def _threads():
    """Two torch threads: the tier-1 run puts six pytest workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cin,v2,batch", CASES)
def test_one_state_dict_loads_into_both(cin, v2, batch):
    system, reference, sd = _pair(cin, v2)
    assert list(system.state_dict()) == list(reference.state_dict()) == list(sd)
    assert ("swinViT.layers1c.0.layer.conv1.conv.weight" in sd) == v2
    assert sd["swinViT.layers1.0.blocks.1.attn.relative_position_index"].shape == (343, 343)
    tables = [m.relative_position_bias_table for m in system.modules()
              if isinstance(m, WindowAttention)]
    assert len(tables) == 8 and all(t.shape == (13 ** 3, t.shape[1]) for t in tables)


@pytest.mark.parametrize("cin,v2,batch", CASES)
def test_forward_matches_reference(cin, v2, batch):
    system, reference, _ = _pair(cin, v2)
    x = _x(cin, batch)
    with torch.no_grad():
        want = reference(x)
        got = system(x)
    assert got.shape == (batch, 32, 32, 32, 3)
    # fp32 on both sides, the same operations summed in other orders (the
    # attention's einsums, cuDNN-free convs, fp32 LayerNorm statistics):
    # 1e-4 of the logits' range
    assert _gap(got, want) < 1e-4


def test_channels_first_io_is_the_same_model():
    system, _, sd = _pair(2, True)
    cf = su.create_swin_unetr(_network(2, True), device="cpu", io_layout="channels_first")
    cf.load_state_dict(sd)
    x = _x(2, 1)
    with torch.no_grad():
        torch.testing.assert_close(cf(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1),
                                   system(x), rtol=0, atol=0)


def test_train_step_matches_reference_autograd():
    system, reference, sd = _pair(2, True)
    system.train()
    x = _x(2, 2)
    seg = torch.randint(0, 3, (2, 32, 32, 32, 1), generator=torch.Generator().manual_seed(2))
    state = tstate.TrainState.create({n: p for n, p in system.named_parameters()},
                                     tstate.make_optimizer(lr=1e-4))
    captured = []
    apply = state.apply_gradients
    state.apply_gradients = lambda grads: (captured.extend(g.clone() for g in grads),
                                           apply(grads))[1]
    step = tstate.make_train_step(system, tl.dice_ce_loss)
    _, metrics = step(state, {"data": x, "seg": seg})

    loss = dice_ce(reference(x), seg)
    names = [n for n, _ in reference.named_parameters()]
    want = torch.autograd.grad(loss, [p for _, p in reference.named_parameters()])
    # fp32 sums in other orders: the loss to 1e-6
    assert abs(float(metrics["loss"]) - loss.item()) <= 1e-6 * abs(loss.item())
    assert list(state.params) == names and len(captured) == len(want)
    scale = max(float(w.norm()) for w in want)
    for name, g, w in zip(names, captured, want):
        # each leaf to 1e-3 of its own norm (InstanceNorm and LayerNorm
        # backwards divide by per-channel deviations, which amplify fp32
        # rounding), with a floor of 1e-6 of the largest leaf's norm for the
        # leaves whose exact gradient is 0 (the key bias of each attention)
        assert float((g - w).norm()) <= 1e-3 * float(w.norm()) + 1e-6 * scale, name


@pytest.mark.parametrize("grid,window,shift", [
    ((21, 21, 21), (7, 7, 7), (3, 3, 3)),
    ((14, 14, 14), (7, 7, 7), (3, 3, 3)),
    ((70, 70, 70), (7, 7, 7), (3, 3, 3)),
    ((14, 7, 21), (7, 7, 7), (3, 0, 3)),
])
def test_shift_labels_are_monai_compute_mask(grid, window, shift):
    labels = win.shift_labels(grid, window, shift)
    assert labels.shape == (np.prod(grid) // np.prod(window), np.prod(window))
    want = ref.compute_mask(grid, window, shift, "cpu")
    assert torch.equal(ac.shift_mask(labels), want)


def test_padding_roll_and_inverse_round_trip():
    x = torch.randn(2, 16, 9, 12, 5)
    window, shift = (7, 7, 7), (3, 3, 3)
    y = win.cyclic_shift(win.pad_to_windows(x, window), [-s for s in shift])
    assert y.shape[1:4] == win.padded_grid(x.shape[1:4], window) == (21, 14, 14)
    back = win.window_unpartition(win.window_partition(y, window), window, y.shape[1:4])
    back = win.cyclic_shift(back, shift)[:, :16, :9, :12]
    assert torch.equal(back, x)


def _no_labels(monkeypatch):
    forward = WindowAttention.forward
    monkeypatch.setattr(WindowAttention, "forward", lambda self, x, labels=None: forward(self, x))


def _flat_merge(monkeypatch):
    def flat(windows, window, grid):
        return windows.reshape(-1, *grid, windows.shape[-1])
    monkeypatch.setattr(su, "window_unpartition", flat)


@pytest.mark.parametrize("plant", [_no_labels, _flat_merge], ids=["no_labels", "flat_merge"])
def test_a_planted_fault_fails_the_forward_comparison(monkeypatch, plant):
    system, reference, _ = _pair(2, True)
    x = _x(2, 2)
    with torch.no_grad():
        want = reference(x)
        plant(monkeypatch)
        got = system(x)
    # ten times the comparison's limit at least (about 80× at this size)
    assert _gap(got, want) > 10 * 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_composition_and_backward_match_float64(dtype):
    """The plain composition with labels (the CPU path and every backward)
    against float64: fp32 scores and softmax, the probabilities rounded to
    the input dtype before PV (bf16: 2^-8 of each)."""
    g = torch.Generator().manual_seed(0)
    bw, h, n, d = 8, 2, 64, 8
    q, k, v = (torch.randn(bw, h, n, d, generator=g) for _ in range(3))
    bias = torch.randn(h, n, n, generator=g) * 0.5
    labels = win.shift_labels((8, 8, 8), (4, 4, 4), (2, 2, 2))
    dout = torch.randn(bw, h, n, d, generator=g)

    def grads(fn, ins):
        ins = [t.detach().clone().requires_grad_(True) for t in ins]
        out = fn(*ins)
        out.float().backward(dout)
        return out.detach().double(), [t.grad.double() for t in ins]

    def f64(q, k, v, b):
        s = torch.einsum("bhqd,bhkd->bhqk", q * d ** -0.5, k) + b[None]
        s = s.view(bw // 8, 8, h, n, n) + ac.shift_mask(labels).double()[None, :, None]
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s.view(bw, h, n, n), -1), v)

    got, got_g = grads(lambda *a: ac.window_attention(*a[:3], a[3], d ** -0.5, labels),
                       [t.to(dtype) for t in (q, k, v)] + [bias])
    want, want_g = grads(f64, [t.to(dtype).double() for t in (q, k, v)] + [bias.double()])
    tol = 1e-5 if dtype == torch.float32 else 1.6e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * float(b.abs().max()))


def test_create_model_dispatches_on_model_type():
    assert isinstance(create_model(NetworkConfig(model_type="SwinUNETR", img_size=32,
                                                 feature_size=12), device="cpu"), su.SwinUNETR)
    with pytest.raises(ValueError, match="Waveformer, SwinUNETR"):
        create_model(NetworkConfig(model_type="UNETR", img_size=32), device="cpu")


@pytest.mark.parametrize("key,value", [("qkv_bias", False), ("mlp_ratio", 2.0),
                                       ("norm_eps", 1e-6), ("downsample", "mergingv2"),
                                       ("decom_levels", [3, 2, 1, 0])])
def test_a_setting_the_model_does_not_build_is_refused(key, value):
    """The factory and the reference refuse a setting they do not build,
    rather than building their fixed model under it."""
    net = {**_network(1, True), key: value}
    with pytest.raises(ValueError, match=key):
        su.create_swin_unetr(net, device="cpu")
    if key != "decom_levels":
        with pytest.raises(ValueError, match=key):
            ref.build(net, "meta")


def test_entry_points_build_and_load_the_swin_model(tmp_path):
    """`scripts.train`, `scripts.predict` and `deploy.process` reach
    `create_model` with `model_type: "SwinUNETR"`: one training step on the
    CPU writes a checkpoint under the state dict's keys, and both serving
    entry points load it into a `SwinUNETR`."""
    import glob

    from waveformer_tpu_torch.deploy.process import InferenceAlgorithm
    from waveformer_tpu_torch.scripts import predict, train
    from waveformer_tpu_torch.tools import synthetic_cases
    from waveformer_tpu_torch.training.checkpoint import load_params_npz

    root = str(tmp_path)
    synthetic_cases.write_training_cases(f"{root}/fullres", n=3, shape=(34, 36, 33), seed=0)
    config = f"{root}/config.yaml"
    with open(config, "w") as f:
        f.write(f"""\
data_dir: "{root}/fullres"
logdir: "{root}/logs/"
data_list_path: "{root}/data_list"
roi_size: [32, 32, 32]
compute_dtype: "float32"
batch_size: 1
max_epoch: 1
num_steps_per_epoch: 1
val_every: 1
val_patches_per_epoch: 1
train_process: 0
logging:
  log_file: "{root}/logs/train.log"
prediction:
  patch_size: [32, 32, 32]
  sw_batch_size: 1
  prediction_save: "{root}/pred"
network:
  model_type: "SwinUNETR"
  in_channels: 4
  out_channels: 4
  img_size: [32, 32, 32]
  feature_size: 12
  use_v2: true
  transformer:
    drop_path_rate: 0.0
""")
    trainer = train.main(["--config", config, "--device", "cpu"])
    assert isinstance(trainer.model, su.SwinUNETR) and trainer.global_step == 1
    (best,) = glob.glob(f"{root}/logs/model/best_model_*.npz")
    params = load_params_npz(best)["params"]
    assert set(params) == {n for n, _ in trainer.model.named_parameters()}

    out = predict.main(["--config", config, "--checkpoint", best, "--split", "val",
                        "--tta", "1", "--device", "cpu"])
    assert out["cases"] == 1 and len(glob.glob(f"{root}/pred/*.nii.gz")) == 1
    alg = InferenceAlgorithm(best, config, input_dir=f"{root}/in", output_dir=f"{root}/out",
                             device="cpu")
    assert isinstance(alg.model, su.SwinUNETR)
    torch.testing.assert_close(alg.model.state_dict()["out.conv.conv.weight"],
                               torch.from_numpy(params["out.conv.conv.weight"]))
