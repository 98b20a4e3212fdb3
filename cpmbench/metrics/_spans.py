"""Shared arithmetic of the span readers: summed event-timed
milliseconds of some spans, per unit of work."""


def per(run, names, count):
    if not run.spans or not count:
        return None
    calls = sum(run.spans.get(n, (0, 0.0))[0] for n in names)
    if not calls:
        return None
    return sum(run.spans[n][1] for n in names) / count
