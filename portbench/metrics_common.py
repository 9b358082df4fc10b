"""Arithmetic the metric readers share."""


def quantile(values, q):
    """The q-quantile of values, by linear interpolation between order
    statistics (numpy's default)."""
    s = sorted(values)
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def idle_pct(profile):
    """100 · (1 − busy / window) of a traced window; None untraced or with no
    device event to read."""
    if profile is None or profile.window_s <= 0 or profile.busy_s <= 0:
        return None
    return 100.0 * (1.0 - profile.busy_s / profile.window_s)
