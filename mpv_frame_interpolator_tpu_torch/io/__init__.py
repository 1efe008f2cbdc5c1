"""Host IO of the port: synthetic sources, the seekable y4m reader and
writer and the raw I420 reader, the page-locked buffer pool the readers
fill, and the frame sinks."""
