"""The benchmark's own span: mean host time from a call's start to its
return, before the synchronise, over the window's calls that were not
traced (the profiler slows the host)."""


def read(r):
    d = [(ret - start) * 1e3 for start, ret, _, traced in r.calls
         if not traced]
    return sum(d) / len(d) if d else None
