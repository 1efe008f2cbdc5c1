"""Frame sinks of the port.  Sources (synthetic clips, y4m readers) are
the JAX package's host modules, imported as they are."""
