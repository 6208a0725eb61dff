"""Checkpoints: best/final params `.npz` files and full-state resume.

Port of `waveformer_tpu/training/checkpoint.py` (reference
`light_training/utils/files_helper.py:6-32` and the periodic saves of
`3_train.py:150-188`):

  * `save_params_npz` / `load_params_npz`: one array per parameter, keyed by
    its flax path joined with "/" (`"encoder1/layer/conv1/conv/kernel"`),
    plus optional JSON metadata beside it. Files written here load in the
    JAX package and the other way round; the nesting is done by hand, with
    no flax. The port's model takes these parameters through
    `utils/jax_params.state_dict_from_jax`; `utils/torch_port.convert_state_dict`
    goes the other way, and `params_tree` applies it to a train state.
    Models the JAX package has no tree for (Swin UNETR) keep their state
    dict keys as the file's keys: `checkpoint_tree` and
    `checkpoint_state_dict` pick the form from the model.
  * `save_new_model_and_delete_last` and `CheckpointManager.save_best` /
    `save_final` / `find_best`: the reference's best/final files, in that
    shared format.
  * `CheckpointManager.save_state` / `load_state` / `latest_checkpoint`:
    the periodic full state for resume, under the JAX package's names
    (`state_epoch_{epoch:05d}` and the `.json` beside it) and its prune
    rule (keep the newest `keep_periodic`). The JAX package writes orbax
    directories; the port, which has no JAX, writes its own format: the
    directory holds `state.npz` with `params/<name>`, `exp_avg/<name>` and
    `exp_avg_sq/<name>` (fp32 masters and AdamW moments by the module's
    parameter names) and `step`.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict in insertion order; empty dicts
    are dropped, as `flax.traverse_util.flatten_dict` drops them."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def save_params_npz(params: Any, path: str, metadata: Optional[Dict] = None):
    """Flat .npz of the param tree (+ JSON metadata)."""
    tree = params["params"] if "params" in params else params
    arrays = {"/".join(k): np.asarray(v) for k, v in _flatten(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f)


def load_params_npz(path: str) -> Dict:
    """`{"params": nested dict of numpy arrays}` from a params .npz."""
    nested: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = nested
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return {"params": nested}


def params_tree(params: Mapping[str, Any], depths: Sequence[int] = (2, 2, 2, 2),
                hf_refinement: bool = False) -> Dict:
    """A train state's masters (by the module's parameter names) as the JAX
    package's `{"params": ...}` tree."""
    from waveformer_tpu_torch.utils.torch_port import convert_state_dict

    return convert_state_dict({k: v.detach().float().cpu() for k, v in params.items()},
                              depths=tuple(depths), hf_refinement=hf_refinement)


def _is_waveformer(model) -> bool:
    from waveformer_tpu_torch.models.waveformer import Waveformer

    return isinstance(model, Waveformer)


def _waveformer_layout(model) -> Tuple[Tuple[int, ...], bool]:
    """(depths, hf_refinement) of a `Waveformer`, as the converters between
    its state dict and the JAX params tree take them."""
    return model.waveformer_encoder.depths, model.decoder4.hf_ref is not None


def checkpoint_tree(model, params: Mapping[str, Any]) -> Dict:
    """`params` (by `model`'s parameter names) as a params file's tree: the
    JAX package's for a `Waveformer`, the names themselves for another
    model."""
    if _is_waveformer(model):
        return params_tree(params, *_waveformer_layout(model))
    return {"params": {k: _np32(v) for k, v in params.items()}}


def checkpoint_state_dict(model, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A params file's tree (`load_params_npz`) as `model`'s state dict,
    for `load_state_dict(strict=True)`: through `state_dict_from_jax` for
    a `Waveformer`; else the file's arrays by name, and `model`'s buffers
    (the relative-position indices, fixed by the shapes) where it has
    none."""
    if _is_waveformer(model):
        from waveformer_tpu_torch.utils.jax_params import state_dict_from_jax

        return state_dict_from_jax(tree, *_waveformer_layout(model))
    params = tree["params"] if "params" in tree else tree
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    for name, buf in model.named_buffers():
        sd.setdefault(name, buf.detach().cpu())
    return sd


def save_new_model_and_delete_last(
    params: Any,
    save_path: str,
    delete_symbol: Optional[str] = None,
    metadata: Optional[Dict] = None,
) -> None:
    """Reference semantics (`files_helper.py:13-32`): remove the previous
    checkpoint whose filename contains `delete_symbol`, then save."""
    save_dir = os.path.dirname(save_path) or "."
    os.makedirs(save_dir, exist_ok=True)
    if delete_symbol is not None:
        for f in glob.glob(os.path.join(save_dir, "*")):
            name = os.path.basename(f)
            if delete_symbol in name and os.path.abspath(f) != os.path.abspath(
                save_path
            ):
                if os.path.isdir(f):
                    shutil.rmtree(f)
                elif os.path.exists(f):  # may be gone as a sibling .json
                    os.remove(f)
                    meta = f + ".json"
                    if os.path.exists(meta):
                        os.remove(meta)
    save_params_npz(params, save_path, metadata)


def _np32(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class CheckpointManager:
    """Best/final/periodic checkpoints of a model directory, with resume."""

    def __init__(self, directory: str, keep_periodic: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_periodic = keep_periodic

    # -------- full state (resume) -------- #
    def _ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"state_epoch_{epoch:05d}")

    def save_state(self, state, epoch: int, extra: Optional[Dict] = None):
        """Periodic full state (masters, AdamW moments, step) of a
        `training.state.TrainState`, in the port's format."""
        path = self._ckpt_path(epoch)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        mu, nu = state.moments()
        arrays = {"step": np.asarray(state.step, np.int64)}
        for group, tree in (("params", state.params), ("exp_avg", mu), ("exp_avg_sq", nu)):
            for name, t in tree.items():
                arrays[f"{group}/{name}"] = _np32(t)
        np.savez(os.path.join(path, "state.npz"), **arrays)
        if extra is not None:
            with open(path + ".json", "w") as f:
                json.dump({"epoch": epoch, **extra}, f)
        self._prune_periodic()

    def _prune_periodic(self):
        ckpts = sorted(glob.glob(os.path.join(self.directory, "state_epoch_*")))
        ckpts = [c for c in ckpts if not c.endswith(".json")]
        for old in ckpts[: -self.keep_periodic]:
            shutil.rmtree(old, ignore_errors=True)
            if os.path.exists(old + ".json"):
                os.remove(old + ".json")

    def latest_checkpoint(self) -> Optional[Tuple[str, int]]:
        ckpts = sorted(glob.glob(os.path.join(self.directory, "state_epoch_*")))
        ckpts = [c for c in ckpts if not c.endswith(".json")]
        if not ckpts:
            return None
        path = ckpts[-1]
        epoch = int(re.search(r"state_epoch_(\d+)", path).group(1))
        return path, epoch

    def load_state(self, state, path: Optional[str] = None):
        """Restore (masters, moments, step) into `state` in place; returns it."""
        if path is None:
            latest = self.latest_checkpoint()
            if latest is None:
                raise FileNotFoundError("no checkpoint to resume from")
            path = latest[0]
        with np.load(os.path.join(path, "state.npz")) as z:
            trees = {g: {n: torch.from_numpy(z[f"{g}/{n}"]) for n in state.params}
                     for g in ("params", "exp_avg", "exp_avg_sq")}
            step = int(z["step"])
        state.load(trees["params"], trees["exp_avg"], trees["exp_avg_sq"], step)
        return state

    # -------- best / final (params only) -------- #
    def save_best(self, params, mean_dice: float, epoch: int, model_name: str):
        save_new_model_and_delete_last(
            params,
            os.path.join(self.directory, f"best_model_{mean_dice:.4f}_{model_name}.npz"),
            delete_symbol="best_model",
            metadata={"epoch": epoch, "mean_dice": mean_dice},
        )

    def save_final(self, params, mean_dice: float, epoch: int, model_name: str):
        save_new_model_and_delete_last(
            params,
            os.path.join(self.directory, f"final_model_{mean_dice:.4f}_{model_name}.npz"),
            delete_symbol="final_model",
            metadata={"epoch": epoch, "mean_dice": mean_dice},
        )

    def find_best(self) -> Optional[str]:
        hits = glob.glob(os.path.join(self.directory, "best_model_*.npz"))
        return hits[0] if hits else None
