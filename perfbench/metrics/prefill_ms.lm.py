"""Device milliseconds of the port's span ``lm.prefill`` in one served job
(every prompt's prefill, nested spans included): the card's stream time
between the span's opening and closing marks, summed over the job's
prefill passes, from the job the ``lm_serve`` driver's ``counters`` runs
with the recorder on (program span)."""


def read(run):
    lm = run["counters"].get("lm")
    if lm is None or "lm.prefill" not in lm["span_ms"]:
        return None
    return lm["span_ms"]["lm.prefill"]
