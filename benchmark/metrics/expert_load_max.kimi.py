"""The busiest held expert's tokens over a held expert's mean, in the
window's decode steps: ``ContinuousBatcher.stats`` ``moe_max_load`` (the
busiest held expert's tokens, summed over layers and steps) over
``moe_assignments`` (the token-expert choices that fell among the held
experts) shared by the ``experts_held`` experts. 1 is an even load; the
step waits on its busiest expert."""

UNIT, LAYER, MOVES = "x", "experts", "answer_tokens_per_s"


def read(rec: dict):
    st = rec.get("stats") or {}
    held = (rec.get("model") or {}).get("experts_held")
    if not st.get("moe_assignments") or not held:
        return None
    return st["moe_max_load"] / (st["moe_assignments"] / (held[1] - held[0]))
