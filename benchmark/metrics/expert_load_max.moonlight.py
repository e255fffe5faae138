"""The busiest expert's tokens over an expert's mean, in the window's
decode steps: ``ContinuousBatcher.stats`` ``moe_max_load`` (the busiest
expert's tokens, summed over layers and steps) over ``moe_assignments``
(token-expert choices) shared by the routed experts. 1 is an even load;
the step waits on its busiest expert."""

UNIT, LAYER, MOVES = "x", "experts", "answer_tokens_per_s"


def read(rec: dict):
    st = rec.get("stats") or {}
    if not st.get("moe_assignments") or "n_routed_experts" not in rec.get("model", {}):
        return None
    return st["moe_max_load"] / (st["moe_assignments"] / rec["model"]["n_routed_experts"])
