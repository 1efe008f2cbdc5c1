"""Measured pair times that the stream-isolation tests give their streams.

The tests overload stream 1 by hand (``OVERLOAD``) and check that stream
0 stays as it was.  Stream 0 would otherwise be judged on the host's real
pair time, so on a loaded host it degraded too; ``pin_healthy`` gives it
``HEALTHY`` before each of its pushes instead."""

# inside the quality controller's dead band at 8 fps (under 125 ms / 1.4,
# over 125 ms / 1.6): the radius and state hold, and no radius change
# costs a compile
HEALTHY = 0.08

# far over any budget a pair: stream 1 degrades on every push
OVERLOAD = 10.0


def pin_healthy(engine) -> None:
    """Set ``engine``'s last measured pair time to ``HEALTHY``, first
    failing if another stream's ``OVERLOAD`` leaked into it."""
    assert engine._last_calc_duration != OVERLOAD, (
        "another stream's overload leaked into this stream's pair time")
    engine._last_calc_duration = HEALTHY
