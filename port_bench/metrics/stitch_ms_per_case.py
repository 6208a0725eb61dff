"""Device ms per case of the operations launched outside the benchmark's
span around the model callable it hands to the inferer: the upload, the
patch gathers, TTA flips, Gaussian accumulation and divide, the argmax
and the read-back."""

from port_bench.trace import MODEL_SPAN


def read(run):
    t, w = run.trace, run.window
    if t is None or not t.attributed or not w["completed"]:
        return None
    return 1e3 * t.device_s(span=MODEL_SPAN, inside=False) / w["completed"]
