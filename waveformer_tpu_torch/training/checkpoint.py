"""Params-only checkpoints in the JAX package's portable `.npz` format.

The part of `waveformer_tpu/training/checkpoint.py` that serving needs:

  * `save_params_npz` / `load_params_npz`: one array per parameter, keyed by
    its flax path joined with "/" (`"encoder1/layer/conv1/conv/kernel"`),
    plus optional JSON metadata beside it. Files written here load in the
    JAX package and the other way round; the nesting is done by hand, with
    no flax.
  * `CheckpointManager(directory).find_best()`: the `best_model_*.npz` that
    training left in a model directory.

The full train-state checkpoints (resume) come with the training entry
points. The port's model takes these parameters through
`utils/jax_params.state_dict_from_jax`; `utils/torch_port.convert_state_dict`
goes the other way.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np


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


class CheckpointManager:
    """The params-only checkpoints of a model directory."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def find_best(self) -> Optional[str]:
        hits = glob.glob(os.path.join(self.directory, "best_model_*.npz"))
        return hits[0] if hits else None
