"""mpv_frame_interpolator_tpu_torch -- the PyTorch + CUDA port of the
frame interpolator, for one NVIDIA Hopper card (sm_90a).

It sits beside the JAX package ``mpv_frame_interpolator_tpu``, which stays
the reference, and keeps that package's layout and names: each module here
is the counterpart of the module at the same path there.  The port covers
the main path only -- 8-bit NV12, model ``hopper``, blended output (mode 2),
scene detection -- and raises ``NotImplementedError`` for anything else.

Its device work is three hand-written CUDA kernels (``csrc/*.cu``), each
with a plain PyTorch twin that is both its specification and its CPU path:

  ops/cuda/flow_step.py  one pyramid step of the block-matching flow
  ops/cuda/blur.py       the 8x8 box blur of the flow field
  ops/cuda/warp_pair.py  every blended output of one source pair

Importing the package touches neither ``torch.cuda`` nor any compiler: the
kernels are built with ``nvcc`` at their first launch (ops/cuda/_build.py).
The package never imports ``jax``; it reuses only the JAX package's host
modules that are free of it (frame, io.synthetic, io.y4m, pipeline.cadence,
pipeline.quality, pipeline.present, ops.oracle, utils).
"""

__version__ = "0.1.0"
