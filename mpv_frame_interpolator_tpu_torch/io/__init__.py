"""Host IO of the port: synthetic sources, the y4m reader and writer, and
the frame sinks."""
