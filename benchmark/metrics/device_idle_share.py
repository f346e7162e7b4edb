"""device_idle_share: the share of the traced slice in which no kernel,
memcpy or memset ran on the card (devtrace.summarize)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
