"""The served window's share of the H100's peaks, in percent: the least
time of the window's jobs at the data sheet's bf16 rate and HBM
bandwidth (``bench/lm_costs.py``: each job's prefill operations, then
its decode bytes: every weight outside the routed experts, the experts
the tokens touched and the latent cache rows they attended), over the
window (host clock). The decode counts are the ``lm_serve`` driver's
counted job's, of its steps that ran layer by layer (on the card the
first; the captured replays count nothing): the experts touched a step
as those steps', the rows attended growing by one a step from theirs.
Every job of the window has the counted job's shape."""
from perfbench.bench import lm_costs


def read(run):
    lm = run["counters"].get("lm")
    if lm is None or not lm.get("decode_counted") \
            or "moe.experts_touched" not in lm["decode_counts"]:
        return None
    cfg, w = run["cfg"], run["window"]
    B, P = lm["requests"], lm["prompt_tokens"]
    steps, c = int(cfg["new_tokens"]) - 1, lm["decode_counted"]
    dc = lm["decode_counts"]
    # step i (1..steps) attends P + i rows a sequence and layer
    rows = dc["mla.cache_rows"] * sum(P + i for i in range(1, steps + 1)) \
        / sum(P + i for i in range(1, c + 1))
    prefill = lm_costs.least_s(lm_costs.prefill_flops(cfg, B, P), 0.0)
    decode = lm_costs.least_s(*lm_costs.decode_work(
        cfg, B, steps, dc["moe.experts_touched"] * steps / c, rows))
    return 100.0 * w["steps"] * (prefill + decode) / w["window_s"]
