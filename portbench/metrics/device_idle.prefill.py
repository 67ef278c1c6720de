"""``device_idle.prefill``: the share of the traced window in which no
operation ran on the device (the union of the profiler's device intervals
against the window's length)."""


def read(run: dict):
    trace = run["trace"]
    if run["mix"]["kind"] != "prefill" or trace["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
