"""Interpolator model families (the port's copy of the JAX package's
``models/__init__.py``; ``tests/test_torch_package.py`` holds it against
the original).

  hopper   -- hierarchical block-matching flow + bidirectional warp
  hopperx  -- hopper + occlusion-aware blending: where the two warped
              samples disagree, the blend shifts toward the temporally
              nearer source (``ops/warp.occlusion_adjust``)
  hopperq  -- hopper + sub-pixel bilinear sampling at 1/64 pel in the
              blended mode (``ops/warp.bilinear_blend``, the kernel Q1)
  hopperxq -- hopperq + hopperx
  blend    -- zero-flow cross-fade (no flow search)
  repeat   -- nearest-source snap (no flow search, every blend position
              snapped to 0 or 1)
"""

MODELS = ("hopper", "hopperx", "hopperq", "hopperxq", "blend", "repeat")


def validate(name: str) -> str:
    if name not in MODELS:
        raise ValueError(f"unknown interpolator model {name!r}; "
                         f"choose from {MODELS}")
    return name
