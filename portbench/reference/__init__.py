"""The benchmark's plain reference of the interpolator.

Plain PyTorch and NumPy, written from the arithmetic of HopperRender's
OpenCL kernels and its filter glue (calcDeltaSumsKernel.cl,
determineLowestLayerKernel.cl, adjustOffsetArrayKernel.cl,
blurFlowKernel.cl, warpFrameKernel.cl, opticalFlowCalc.c,
vf_HopperRender.c) with the interpolator's stated semantics on top: the
exact fixed-point blend, exact-integer black/white levels, 10-bit P010 on
the 8-bit scale, the scene-cut score and its fold.

It imports nothing of the program under test (nor of the JAX package):
it takes the source planes the benchmark made and works the cut, the
flow and the warp out again from them.

* ``cadence`` -- which outputs (pts, blend position) each source frame
  emits;
* ``pair`` -- one source pair: the cut score and decision, the folded
  positions, the flow pyramid and its blur, and each blended output.
"""
