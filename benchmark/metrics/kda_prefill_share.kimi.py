"""The share of the traced prefills' device time that their KDA layers
take: the device operations launched inside the prefills' ``lm.kda``
spans over those launched inside their whole ``cb.prefill.launch``
spans, each a union of intervals (``rec["part_prefills"]``)."""

UNIT, LAYER, MOVES = "%", "linear attention", "answer_p95_ms"


def read(rec: dict):
    pre = [p for p in rec.get("part_prefills") or () if p.get("total_s", 0) > 0]
    if not pre or not any(p.get("kda_s", 0) > 0 for p in pre):
        return None
    return 100.0 * sum(p["kda_s"] for p in pre) / sum(p["total_s"] for p in pre)
