"""Device math of the port: the flow pyramid and the blended warp, on
torch tensors, with their kernels in ops/cuda."""
