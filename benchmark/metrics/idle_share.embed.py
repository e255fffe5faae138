"""One minus the union of the device's busy intervals over the traced
window (``torch.profiler``)."""

UNIT, LAYER, MOVES = "%", "device", "embed_chunks_per_s"


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
