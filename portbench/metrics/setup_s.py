"""setup_s (s): from the start of the process to the end of the warm-up
(import, the kernels' library, the ring made on the card, the engine,
the cell's own calls and the group graph's capture), on the host clock."""


def read(run):
    return run.setup_s
