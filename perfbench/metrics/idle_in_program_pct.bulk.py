"""The share of the traced bulk window's device idle (the gaps between
device records) that lies inside a span of the port, in percent; the
rest is the caller's loop between calls into the port."""


def read(run):
    sp = run.get("spans")
    if sp is None or run["wl"]["loop"] != "closed":
        return None
    g = sp["attribution"]["gaps"]
    if not sp["window"]["spans"] or g["idle_s"] <= 0:
        return None
    return 100.0 * g["in_span_s"] / g["idle_s"]
