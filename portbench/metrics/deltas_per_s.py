"""``deltas_per_s``: bucket-lane deltas whose interval the node
acknowledged inside the window, over the window's seconds; host clock."""


def read(ctx):
    return ctx["peers"]["acked_entries"] / ctx["window_s"]
