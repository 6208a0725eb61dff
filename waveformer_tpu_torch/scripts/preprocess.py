"""Step 2 — plan + preprocess the raw dataset (reference
`2_preprocessing_mri.py`): fingerprint, then crop/normalize/resample every
case to npz/pkl artifacts.

    python -m waveformer_tpu_torch.scripts.preprocess --config config.yaml \
        [--raw-dir DIR] [--out-dir DIR] [--num-processes N] \
        [--dataset-type mri|mri-global|ct|ct-organs|multi-input] [--plan-only]

The CLI and artifacts of `waveformer_tpu/scripts/preprocess.py`: the same
flags, `plans.json` and `{case}.npz` + `{case}.pkl`. The config is read by
the port's `load_config` (no PyYAML); the script imports no torch.
"""

from __future__ import annotations

import argparse
import json
import os

from waveformer_tpu_torch.config import load_config
from waveformer_tpu_torch.data.planning import PLANS_FILENAME, Plans
from waveformer_tpu_torch.data.preprocessing import (
    CTPreprocessor,
    GlobalContextPreprocessor,
    MultiInputRegionPreprocessor,
    MultiModalityPreprocessor,
    OrganMaskPreprocessor,
)

BRATS_MODALITIES = ("t2w.nii.gz", "t2f.nii.gz", "t1n.nii.gz", "t1c.nii.gz")


def build_preprocessor(args, raw_dir):
    """Select the dataset driver (reference's per-dataset preprocessor files,
    `light_training/preprocessing/preprocessors/`)."""
    if args.dataset_type == "mri":
        return MultiModalityPreprocessor(
            base_dir=os.path.dirname(raw_dir.rstrip("/")) or ".",
            image_dir=os.path.basename(raw_dir.rstrip("/")),
            data_filenames=tuple(args.modalities),
            seg_filename=args.seg_filename,
        )
    if args.dataset_type == "mri-global":
        return GlobalContextPreprocessor(
            base_dir=os.path.dirname(raw_dir.rstrip("/")) or ".",
            image_dir=os.path.basename(raw_dir.rstrip("/")),
            data_filenames=tuple(args.modalities),
            seg_filename=args.seg_filename,
            global_size=tuple(args.global_size),
        )
    if args.dataset_type == "ct":
        return CTPreprocessor(
            base_dir=raw_dir,
            volume_prefix=args.volume_prefix,
            seg_prefix=args.seg_prefix,
            foreground_classes=tuple(args.foreground_classes),
        )
    if args.dataset_type == "ct-organs":
        if not args.organ_list:
            raise SystemExit("--organ-list required for ct-organs")
        return OrganMaskPreprocessor(
            base_dir=raw_dir,
            image_name=args.image_name,
            seg_list=tuple(args.organ_list),
        )
    if args.dataset_type == "multi-input":
        regions = ()
        if args.regions:
            regions = tuple(
                tuple(int(v) for v in group.split(",")) for group in args.regions
            )
        return MultiInputRegionPreprocessor(
            base_dir=os.path.dirname(raw_dir.rstrip("/")) or ".",
            image_dir=os.path.basename(raw_dir.rstrip("/")),
            data_filenames=tuple(args.modalities),
            seg_filename=args.seg_filename,
            regions=regions,
        )
    raise SystemExit(f"unknown dataset type {args.dataset_type!r}")


def main(argv=None):
    """Run the script; returns the names of the cases preprocessed (none
    with `--plan-only`)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--raw-dir", default=None, help="override raw_data_dir")
    ap.add_argument("--out-dir", default=None, help="override data_dir")
    ap.add_argument("--num-processes", type=int, default=8)
    ap.add_argument(
        "--dataset-type",
        choices=("mri", "mri-global", "ct", "ct-organs", "multi-input"),
        default="mri",
        help="mri: per-case modality dirs (BraTS); mri-global: mri plus a "
        "downsampled whole-volume context pair stored as data_global/"
        "seg_global (BraTS23-global, preprocessor_brats23_global.py); ct: "
        "flat volume-*/segmentation-* pairs (liver2017); ct-organs: "
        "per-case dir with one CT + per-organ binary masks (AbdomenAtlas); "
        "multi-input: N input images per case + region-format labels (CT "
        "normalization)",
    )
    ap.add_argument(
        "--global-size", nargs=3, type=int, default=[128, 128, 128],
        help="whole-volume context shape for mri-global",
    )
    ap.add_argument(
        "--regions", nargs="+", default=None,
        help="region label groups for multi-input, each a comma list, "
        "e.g. --regions 1,2,3 2,3 3 for BraTS WT/TC/ET",
    )
    ap.add_argument(
        "--modalities", nargs="+", default=list(BRATS_MODALITIES)
    )
    ap.add_argument("--seg-filename", default="seg.nii.gz")
    ap.add_argument("--volume-prefix", default="volume-")
    ap.add_argument("--seg-prefix", default="segmentation-")
    ap.add_argument("--image-name", default="ct.nii.gz")
    ap.add_argument("--organ-list", nargs="+", default=None,
                    help="per-organ mask filenames, label order (ct-organs)")
    ap.add_argument("--foreground-classes", nargs="+", type=int,
                    default=[1, 2], help="labels to oversample (ct)")
    ap.add_argument("--plan-only", action="store_true")
    args = ap.parse_args(argv)

    cfg = load_config(args.config) if os.path.exists(args.config) else None
    raw_dir = args.raw_dir or (cfg.raw_data_dir if cfg else None)
    out_dir = args.out_dir or (cfg.data_dir if cfg else None)
    if not raw_dir or not out_dir:
        ap.error("--raw-dir/--out-dir required (or provide a config.yaml)")

    pp = build_preprocessor(args, raw_dir)
    plan = pp.run_plan()
    os.makedirs(out_dir, exist_ok=True)
    # persist as a first-class artifact that scripts.train round-trips
    # (reference plans handler, `light_training/utilities/plans_handling/`)
    plans = Plans.from_plan(
        plan,
        normalization=pp.normalization,
        foreground_classes=pp.foreground_classes,
    )
    plans.save(os.path.join(out_dir, PLANS_FILENAME))
    print(json.dumps(plan, indent=2))
    if args.plan_only:
        return []
    # CT normalization needs the fingerprint percentiles (reference:
    # `preprocessor_abdomen_atlas.py` collect_foreground_intensities).
    intensity_props = None
    if pp.normalization == "ct":
        intensity_props = {
            int(k): v for k, v in plan["intensities_per_channel"].items()
        }
    done = pp.run(out_dir, num_processes=args.num_processes,
                  intensity_props=intensity_props)
    print(f"preprocessed {len(done)} cases -> {out_dir}")
    return done


if __name__ == "__main__":
    main()
