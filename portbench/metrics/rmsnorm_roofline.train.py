"""K1 (``csrc/rmsnorm.cu``) in a train step: the least time of the step's
norm work from the configuration's shapes (ln1 and ln2 of every layer and
the final norm on the B x S rows, bytes once at 3.35 TB/s) over the device
time of the kernels named ``rmsnorm_*`` a step, in %. Nothing when K1 is
off the step's path (no launch); a traced run in which it launches other
than the configuration implies, or leaves no device time under that name,
fails, since this reading's work would no longer be K1's."""
from portbench.harness import peaks
from portbench.harness.trace import device_seconds, expected_launches


def read(record):
    tr, s, mix = record.get("trace"), record["shape"], record["mix"]
    if tr is None or not expected_launches(tr, "rmsnorm", peaks.train_norm_launches(s)):
        return None
    t = device_seconds(tr, r"^rmsnorm_", required=True) / tr.units
    return 100.0 * peaks.train_norm_launches(s) * peaks.rmsnorm_bound_s(
        mix["batch"] * mix["seq"], s.hidden) / t
