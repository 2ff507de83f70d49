"""The share of the layers' stream time inside the port's ``moe.*`` spans
(routing, the routed experts' grouped products, the shared experts), in
percent, over the spans that hold layer spans: ``lm.prefill`` and the
decode steps that run layer by layer (program span; the ``lm_serve``
driver's ``counters``, one served job). On the card the decode steps
after the first replay a captured graph and open no spans, so the share
is the prefill's and the first step's; a replayed step's time is
``decode_step_ms.lm``'s."""

MOE = ("moe.route", "moe.experts", "moe.shared")


def read(run):
    lm = run["counters"].get("lm")
    if lm is None or not lm.get("layer_ms") \
            or not any(n in lm["span_ms"] for n in MOE):
        return None
    return 100.0 * sum(lm["span_ms"].get(n, 0.0) for n in MOE) \
        / lm["layer_ms"]
