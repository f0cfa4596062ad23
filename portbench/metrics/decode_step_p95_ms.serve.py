"""The 95th percentile of the gaps between consecutive served tokens of
every request in the window (a decode step of the engine through the KV
cache and the cached attention, host-bound while decode is eager), in ms:
the time between tokens that a user of the serve cell sees, kept as a
per-layer metric because its spread between runs needs a bound over 25%."""
import numpy as np


def read(record):
    gaps = record.get("gaps_s")
    return 1e3 * float(np.percentile(gaps, 95)) if gaps else None
