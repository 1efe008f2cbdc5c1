"""group.launches_per_pair (launches): kernel launches a pair over the
measured window of the cells that drive ``push_many``.  The same reading
as engine.launches_per_pair, whose ``read`` it calls, kept apart because
a per-layer metric moves one end-to-end metric and this one moves
out_fps.  None where nothing launched (the CPU)."""

from portbench import spec

read = spec.reader("engine.launches_per_pair").read
