"""Toolchain probes of the port on the card: ``pack_probe`` (packed-byte
primitives, csrc/pack_probe.cu) and ``dma_probe`` (which window starts
and sizes the asynchronous copies accept, csrc/dma_probe.cu).  Each runs
as ``python -m mpv_frame_interpolator_tpu_torch.tools.<name>``."""
