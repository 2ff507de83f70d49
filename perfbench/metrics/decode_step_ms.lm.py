"""Device milliseconds of one decode step in the steady state: the mean
of the port's ``lm.decode`` spans that replay the captured step on the
card (the card's stream time between the span's marks, the stream's
waits for the host inside it included), the first step, which runs
layer by layer, left out; off the card, where no step is replayed, every
step's (program span; the ``lm_serve`` driver's ``counters``, one served
job)."""


def read(run):
    lm = run["counters"].get("lm")
    if lm is None or not lm.get("step_ms"):
        return None
    return lm["step_ms"]
