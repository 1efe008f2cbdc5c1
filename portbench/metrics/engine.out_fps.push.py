"""engine.out_fps.push (frames/s): every output frame the window's
``push`` calls emitted, over the window (first call to the card's
completion of the last), on the host clock: the rate at which the
engine's host code delivers pairs back to back."""


def read(run):
    return run.outputs / run.window_s
