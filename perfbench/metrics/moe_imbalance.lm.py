"""The routed experts' load imbalance in one served job: the most rows any
expert got, over the mean rows an expert (assignments over the routed
experts), summed over the job's layer-steps that run layer by layer,
so each weighs by its assignments: the prefill's and, on the card, the
first decode step's (the replayed steps count nothing; program counters
``moe.expert_rows_max`` and ``moe.assignments``; 1 is even, the
routed-expert count the worst)."""


def read(run):
    lm = run["counters"].get("lm")
    c = {} if lm is None else lm["counts"]
    if not c.get("moe.assignments"):
        return None
    mean = c["moe.assignments"] / run["cfg"]["n_routed_experts"]
    return c["moe.expert_rows_max"] / mean
