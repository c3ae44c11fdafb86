"""Per cent of the profiled stretch of the cell's own path in which no
operation ran on the device (1 - the union of its operations'
intervals over the stretch's wall)."""
from harness.readers import idle_share


def read(run):
    return idle_share(run)
