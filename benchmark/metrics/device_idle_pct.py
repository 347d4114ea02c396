"""100 - the device's busy share of the traced window (the union of its
kernels, copies and fills over the window's length), the mean over the
ranks."""


def read(r):
    t = [rank["trace"] for rank in r.ranks if rank["trace"]]
    t = [x for x in t if x["busy_s"] > 0]
    if not t:
        return None
    return sum(100.0 * (1.0 - x["busy_s"] / x["window_s"]) for x in t) / len(t)
