"""Policy executor: the wall of the HOOK_FAULT program per batch call
(telemetry's ``observe_hook`` for ``mm_fault``), microseconds, over the
window's calls."""


def read(rec):
    total_ns, calls = rec.hook_fault
    if calls <= 0:
        return None
    return total_ns / calls / 1e3
