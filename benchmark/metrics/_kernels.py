"""Device seconds a traced call of the operations whose names hold a
pattern, from rank 0's trace; None where none ran."""


def ms_per_call(r, pattern: str):
    r0 = r.rank0
    t = r0["trace"]
    if not t:
        return None
    s = [v for k, v in t["device_s"].items() if pattern in k]
    return sum(s) * 1e3 / r0["profiled"] if s else None
