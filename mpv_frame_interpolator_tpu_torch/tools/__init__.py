"""Tools of the port on the card: the toolchain probes ``pack_probe``
(packed-byte primitives, csrc/pack_probe.cu) and ``dma_probe`` (which
window starts and sizes the asynchronous copies accept,
csrc/dma_probe.cu); ``parity_report`` (the kernels against the NumPy
oracle), ``chip_time`` (device ms a pair from CUDA graphs) and
``multi_card`` (the sharded step on NCCL and the pair pool across every
visible card).  Each runs as ``python -m
mpv_frame_interpolator_tpu_torch.tools.<name>``."""
