"""Device-side quality metrics (counterpart of the JAX package's
``ops/metrics.py``): PSNR and the mean absolute difference computed where
the planes live, so quality monitoring downloads no frame.

Both are plain PyTorch reductions, as the JAX package's are plain
``jax.jit`` functions (no kernel of its own).  Planes that are tensors
stay on their device; numpy planes go to `device` ("cuda" unless the
caller passes "cpu"; without a card that raises).  A float32 reduction
in another order than XLA's differs in the last bits, so ``psnr_device``
agrees with the JAX package's within 1e-5 relative; ``mean_abs_diff``
sums exactly (int64) and divides once in float32, which equals the JAX
package's float32 mean while the sum stays below 2**24.
"""

from __future__ import annotations

import torch


def _planes(a, b, device):
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, device=device)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=device)
    if a.shape != b.shape:
        raise ValueError(f"planes of shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"planes on {a.device} and {b.device}")
    return a, b


def psnr_device(a, b, peak: int = 255, device="cuda") -> torch.Tensor:
    """PSNR between two equal-shape integer planes, as a 0-dim float32
    tensor on their device (999.0 for identical planes)."""
    a, b = _planes(a, b, device)
    d = a.to(torch.float32) - b.to(torch.float32)
    mse = torch.mean(d * d)
    return torch.where(mse == 0, torch.tensor(999.0, device=a.device),
                       10.0 * torch.log10(float(peak * peak) / mse))


def mean_abs_diff(a, b, device="cuda") -> torch.Tensor:
    """Mean |a - b| as a 0-dim float32 tensor on the planes' device (the
    scene detector's metric, available standalone)."""
    a, b = _planes(a, b, device)
    total = (a.to(torch.int32) - b.to(torch.int32)).abs().sum(
        dtype=torch.int64)
    return total.to(torch.float32) / a.numel()
