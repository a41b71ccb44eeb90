"""``device.idle_pct.deltas``: the share of the traced window in which no
kernel, copy or fill ran on the card, in percent (100 less the union of
the device's records over the window's length by the host's clock)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
