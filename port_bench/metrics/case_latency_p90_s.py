"""The 90th percentile of the window's case latencies, host volume in to
label map out (linear interpolation between order statistics)."""

import numpy as np


def read(run):
    lat = run.window.get("latencies_s")
    return float(np.percentile(lat, 90)) if lat else None
