"""Model step: the mean of the program's ``dev decode`` spans in the
window (CUDA events from before the decode graph's input copy to after its
output copy, on the telemetry's clock), in milliseconds."""


def read(rec):
    d = [dur for name, dur in rec.spans if name == "dev decode"]
    if not d:
        return None
    return sum(d) / len(d) / 1e6
