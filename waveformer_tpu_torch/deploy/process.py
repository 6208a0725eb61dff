"""Containerized inference harness (grand-challenge style).

    python -m waveformer_tpu_torch.deploy.process --checkpoint best_model.npz \
        [--config config.yaml] [--input-dir /input] [--output-dir /output] \
        [--modalities t2w.nii.gz t2f.nii.gz t1n.nii.gz t1c.nii.gz] [--no-tta]
        [--device cuda|cpu]

Port of `waveformer_tpu/deploy/process.py` (reference `Customalgorithm`,
`light_training/process_framework/process.py:8`): reads raw volumes from an
input directory (one directory of modality NIfTIs per case), runs the full
preprocess (crop, z-score, resample) → sliding-window patch TTA on the
device → geometry restore pipeline, and writes `{case}.nii.gz` label maps
in each source file's voxel order and affine. Designed for /input → /output
container conventions but path-configurable. The model is the config's
(`models.create_model`: WaveFormer or Swin UNETR by `network.model_type`);
the weights are a params `.npz` in `training.checkpoint.checkpoint_state_dict`'s
form for it (the JAX package's for WaveFormer); the model runs on the CUDA
device unless `--device cpu` is given. A missing config
path means the default `Config()`, as in the JAX wrapper.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch

from waveformer_tpu_torch.config import Config, load_config
from waveformer_tpu_torch.data.preprocessing import MultiModalityPreprocessor
from waveformer_tpu_torch.device import resolve_device
from waveformer_tpu_torch.inference import Predictor, SlidingWindowInferer
from waveformer_tpu_torch.models import create_model
from waveformer_tpu_torch.training.checkpoint import checkpoint_state_dict, load_params_npz

BRATS_MODALITIES = ("t2w.nii.gz", "t2f.nii.gz", "t1n.nii.gz", "t1c.nii.gz")


class InferenceAlgorithm:
    """End-to-end single-case algorithm wrapper. `case_times` holds one
    dict of host seconds per processed case: `read_s` (NIfTI decode),
    `preprocess_s` (`run_case_npy`), `predict_s` (`predict_case`, upload to
    label map) and `write_s` (`save_to_nii`)."""

    def __init__(
        self,
        checkpoint: str,
        config_path: Optional[str] = None,
        input_dir: str = "/input",
        output_dir: str = "/output",
        modalities: Sequence[str] = BRATS_MODALITIES,
        use_tta: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = (
            load_config(config_path)
            if config_path and os.path.exists(config_path)
            else Config()
        )
        self.input_dir = input_dir
        self.output_dir = output_dir
        self.modalities = tuple(modalities)
        self.case_times = []

        dtype = torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else torch.float32
        self.model = create_model(self.cfg.network, dtype=dtype, device=self.device,
                                  io_layout="channels_first")
        self.model.load_state_dict(
            checkpoint_state_dict(self.model, load_params_npz(checkpoint)), strict=True)
        inferer = SlidingWindowInferer(
            roi_size=self.cfg.prediction.patch_size,
            sw_batch_size=self.cfg.prediction.sw_batch_size,
            overlap=self.cfg.prediction.overlap,
            mirror_axes=self.cfg.prediction.mirror_axes if use_tta else None,
            layout="channels_first",
            tta_mode="patch",
        )
        self.predictor = Predictor(inferer, upload_dtype=dtype, device=self.device)
        self.preprocessor = MultiModalityPreprocessor(
            base_dir=os.path.dirname(input_dir.rstrip("/")) or "/",
            image_dir=os.path.basename(input_dir.rstrip("/")),
            data_filenames=self.modalities,
            seg_filename=None,
        )

    def process_case(self, case_name: str) -> str:
        t0 = time.perf_counter()
        data, _, props = self.preprocessor.read_data(case_name)
        t1 = time.perf_counter()
        data, _, props = self.preprocessor.run_case_npy(data, None, props)
        t2 = time.perf_counter()
        seg = self.predictor.predict_case(
            data,  # already (C, D, H, W): the channels-first pipeline's layout
            self.model,
            out_channels=self.cfg.network.out_channels,
            properties=props,
        )
        t3 = time.perf_counter()
        os.makedirs(self.output_dir, exist_ok=True)
        out_path = os.path.join(self.output_dir, case_name + ".nii.gz")
        self.predictor.save_to_nii(
            seg, out_path, spacing=props.get("spacing", (1, 1, 1)),
            properties=props,  # write back in the SOURCE voxel geometry
        )
        self.case_times.append({"case": case_name, "read_s": t1 - t0,
                                "preprocess_s": t2 - t1, "predict_s": t3 - t2,
                                "write_s": time.perf_counter() - t3})
        return out_path

    def process(self) -> int:
        cases = sorted(
            d for d in os.listdir(self.input_dir)
            if os.path.isdir(os.path.join(self.input_dir, d))
        )
        for case in cases:
            t0 = time.time()
            path = self.process_case(case)
            print(f"{case}: {path} ({time.time() - t0:.1f}s)", flush=True)
        return len(cases)


def main(argv=None):
    """Run the wrapper; returns the `InferenceAlgorithm` it ran."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--input-dir", default="/input")
    ap.add_argument("--output-dir", default="/output")
    ap.add_argument("--modalities", nargs="+", default=list(BRATS_MODALITIES))
    ap.add_argument("--no-tta", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs "
                    "the kernels' plain versions)")
    args = ap.parse_args(argv)
    algo = InferenceAlgorithm(
        checkpoint=args.checkpoint,
        config_path=args.config,
        input_dir=args.input_dir,
        output_dir=args.output_dir,
        modalities=args.modalities,
        use_tta=not args.no_tta,
        device=args.device,
    )
    n = algo.process()
    print(f"processed {n} cases")
    return algo


if __name__ == "__main__":
    main()
