"""Sum of each decode_attention call's bound (its K/V bytes at the rows'
lengths, read once) over the sum of the kernel's device time."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["decode_device_s"] <= 0:
        return None
    return 100.0 * tr["decode_bound_s"] / tr["decode_device_s"]
