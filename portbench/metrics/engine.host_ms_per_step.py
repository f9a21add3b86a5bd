"""Engine loop: the host's milliseconds per engine step — the step's
wall (from the call to its return, the card's work done) less the device
time of the entries bracketed in that step — over every step of the
window."""


def read(rec):
    if not rec.steps:
        return None
    return sum(s["wall_ms"] - s["device_ms"] for s in rec.steps) \
        / len(rec.steps)
