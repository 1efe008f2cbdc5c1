"""Host pipeline of the port: the interpolation engine, scene-cut score,
output cadence, quality controller, present clock and the source ->
engine -> sink loop."""
