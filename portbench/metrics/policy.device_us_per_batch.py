"""Policy executor: the device's microseconds per policy batch — the
program's ``dev policy`` spans (the ctx rows' copy up, the policy-program
kernel and the decisions' copy down, by CUDA events on the telemetry's
clock), mean over the window's batches."""


def read(rec):
    dev = [d for name, d in rec.spans if name == "dev policy"]
    if not dev:
        return None
    return sum(dev) / len(dev) / 1e3
