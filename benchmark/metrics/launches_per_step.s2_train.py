"""Device kernels a stage-2 step launches: the kernels in the traced
window (copies and sets left out) over its steps."""

from benchmark import readers


def read(run):
    s, steps = readers.traced(run)
    if s is None:
        return None
    n = sum(1 for name, _, _ in s["kernels"]
            if not name.startswith(("Memcpy", "Memset")))
    return n / steps
