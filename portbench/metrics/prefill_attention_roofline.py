"""Sum of each prefill_attention call's bound (the larger of its
operations and bytes at its q_offset and length) over the sum of the
kernel's device time."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["prefill_device_s"] <= 0:
        return None
    return 100.0 * tr["prefill_bound_s"] / tr["prefill_device_s"]
