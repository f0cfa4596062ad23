"""The device's idle share while serving: 1 - the union of the device
events' intervals over the host seconds of the profiled sub-window, in %."""
from portbench.harness.trace import idle_share


def read(record):
    return idle_share(record.get("trace"))
