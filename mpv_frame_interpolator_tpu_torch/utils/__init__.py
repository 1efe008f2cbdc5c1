"""Host utilities of the port: component logging and the stats registry
(copies of the JAX package's ``utils.logging`` and ``utils.stats``)."""

from mpv_frame_interpolator_tpu_torch.utils.logging import get_logger  # noqa: F401
from mpv_frame_interpolator_tpu_torch.utils.stats import StatsRegistry  # noqa: F401
