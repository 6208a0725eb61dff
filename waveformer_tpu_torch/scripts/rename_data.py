"""Step 1 — normalize raw BraTS filenames (reference `1_rename_mri_data.py`).

Strips the `BraTS-GLI-XXXXX-XXX-` prefix from each modality file so cases
read as `{t1c,t1n,t2f,t2w,seg}.nii.gz`.

    python -m waveformer_tpu_torch.scripts.rename_data RAW_DIR [--dry-run]

A copy of `waveformer_tpu/scripts/rename_data.py` (standard library only).
"""

from __future__ import annotations

import argparse
import os


def rename_dataset(raw_dir: str, dry_run: bool = False) -> int:
    n = 0
    for case in sorted(os.listdir(raw_dir)):
        case_dir = os.path.join(raw_dir, case)
        if not os.path.isdir(case_dir):
            continue
        for fname in os.listdir(case_dir):
            if not fname.endswith(".nii.gz"):
                continue
            # BraTS-GLI-00000-000-t1c.nii.gz → t1c.nii.gz
            parts = fname[: -len(".nii.gz")].split("-")
            new = parts[-1] + ".nii.gz"
            if new == fname:
                continue
            src = os.path.join(case_dir, fname)
            dst = os.path.join(case_dir, new)
            print(f"{src} -> {dst}")
            if not dry_run:
                os.rename(src, dst)
            n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("raw_dir", help="raw dataset root (one dir per case)")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    n = rename_dataset(args.raw_dir, args.dry_run)
    print(f"renamed {n} files")


if __name__ == "__main__":
    main()
