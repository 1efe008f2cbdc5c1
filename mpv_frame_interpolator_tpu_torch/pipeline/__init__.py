"""Host pipeline of the port: the interpolation engine, scene-cut score and
the source -> engine -> sink loop.  The cadence engine, the quality
controller and the present clock are the JAX package's own host modules,
imported as they are."""
