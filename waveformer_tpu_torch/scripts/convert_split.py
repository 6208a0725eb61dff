"""Convert plain-text case lists to the pickle split format
(reference `data_property/data_read.py:1-24` capability).

    python -m waveformer_tpu_torch.scripts.convert_split cases.txt test_list.pkl

A copy of `waveformer_tpu/scripts/convert_split.py` (standard library only).
"""

from __future__ import annotations

import argparse
import pickle


def txt_to_pkl(txt_path: str, pkl_path: str) -> int:
    with open(txt_path) as f:
        cases = [line.strip() for line in f if line.strip()]
    with open(pkl_path, "wb") as f:
        pickle.dump(cases, f)
    return len(cases)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("txt", help="one case name per line")
    ap.add_argument("pkl", help="output pickle path")
    args = ap.parse_args(argv)
    n = txt_to_pkl(args.txt, args.pkl)
    print(f"wrote {n} case names -> {args.pkl}")


if __name__ == "__main__":
    main()
