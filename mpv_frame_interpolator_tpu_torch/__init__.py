"""mpv_frame_interpolator_tpu_torch -- the PyTorch + CUDA port of the
frame interpolator, for one NVIDIA Hopper card (sm_90a).

It sits beside the JAX package ``mpv_frame_interpolator_tpu``, which stays
the reference, and keeps that package's layout and names: each module here
is the counterpart of the module at the same path there.  It imports
nothing of that package: the host modules it needs (frame, io.synthetic,
io.y4m, pipeline.cadence, pipeline.quality, pipeline.present, utils and
the flow geometry of ops.oracle) are its own copies.  The port covers
model ``hopper``, blended output (mode 2), scene detection, 8-bit NV12 and
10-bit P010, any black/white levels, and the "pair" and "fused" warp
samplers; it raises ``NotImplementedError`` for anything else.

Its device work is four hand-written CUDA kernels (``csrc/*.cu``), each
with a plain PyTorch twin that is both its specification and its CPU path:

  ops/cuda/flow_step.py  K1: one pyramid step of the block-matching flow
  ops/cuda/blur.py       K3: the 8x8 box blur of the flow field
  ops/cuda/warp_pair.py  K2: every blended output of one source pair
  ops/cuda/warp_fused.py K4: the blended output of one blend position

Importing the package touches neither ``torch.cuda`` nor any compiler: the
kernels are built with ``nvcc`` at their first launch (ops/cuda/_build.py).
"""

__version__ = "0.1.0"
