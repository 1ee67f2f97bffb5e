"""A kernel's share of its roofline over the traced stretch: the least time
the card could take for every launch the stretch made (``frozen/work.py``,
from each launch's shapes and data) over the kernel's device time in the
profile, in percent."""

from bench.frozen import work


def share(ctx, calls: str, names) -> float:
    launches = ctx.run.calls.get(calls)
    if ctx.summary is None or not launches:
        return None
    t = ctx.summary.kernel_seconds(names)
    if t <= 0:
        return None
    return 100.0 * sum(work.least_seconds(w) for w in launches) / t
