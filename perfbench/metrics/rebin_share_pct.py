"""The share of the window's steps that a rebin preceded, from the
driver's ``prof["rebin_steps"]`` (the large-F path's rebin policy)."""


def read(ctx):
    prof = ctx["prof"]
    if "rebin_steps" not in prof:
        return None
    n = ctx["steps"]
    return 100.0 * sum(1 for k in prof["rebin_steps"] if 0 < k < n) / n
