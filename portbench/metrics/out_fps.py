"""out_fps (frames/s): every output frame the window's calls emitted,
over the window -- from the first call to the moment the card finished
the last of them (in-flight work drained) -- on the host clock."""


def read(run):
    return run.outputs / run.window_s
