"""The window's required work over what the card could do in it: the sum
over iterations of the larger of operations / 989 TFLOP/s and bytes /
3.35 TB/s (weights read once an iteration, K/V read and written, each
token's products, the real chunk tokens' attention), over the window."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["required_s"] <= 0:
        return None
    return 100.0 * tr["required_s"] / tr["window_s"]
