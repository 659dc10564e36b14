"""Settings that keep the port's property tests independent of the
machine's load. Under several test workers beside busy files, drawing a
first example can take longer than hypothesis allows (its ``too_slow``
health check, 1 s) and an example can outlast its 200 ms deadline, though
the property holds; the example counts stay as each test sets them. The
deterministic fallback of ``_hypothesis_compat`` times nothing."""
from _hypothesis_compat import HAVE_HYPOTHESIS

if HAVE_HYPOTHESIS:
    from hypothesis import HealthCheck
    UNTIMED = {"deadline": None,
               "suppress_health_check": [HealthCheck.too_slow]}
else:
    UNTIMED = {}
