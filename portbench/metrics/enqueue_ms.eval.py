"""Mean host ms per map inside the model call, up to its return (the
unprofiled part of the traced run's window)."""


def read(r):
    calls = r.host["calls"]
    return 1e3 * sum(calls) / len(calls) if calls else None
