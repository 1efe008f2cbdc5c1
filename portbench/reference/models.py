"""Which plain reference judges a configuration's outputs.

A configuration without a ``reference`` key is judged by hopper's blend,
``pair.py``; one with ``"reference": "<name>"`` by ``reference/<name>.py``,
loaded by name as ``spec.reader`` loads a metric's reader.  Adding a
model's reference is that one file and the key in its configuration.  A
reference module has:

* ``COVERS``: {configuration key: the values it judges}, over the keys of
  the configuration (the benchmark's own and every field of the engine's
  configuration, filled in by ``run.engine_config``) that change what the
  outputs are -- at least ``model``, ``frame_output_mode`` and
  ``subpel_flow``;
* ``outputs(f1, f2, geom, folded, cfg, scale_shift, levels)``: the pair's
  blended outputs, an iterable of (y, uv) int64 planes, one for each
  folded position of ``folded`` (``pair.Folded``, from the shared
  ``pair.prologue``: the cut score, the cut decision and the fold), in
  order; f1 and f2 are the source pair's (y, uv) planes as the benchmark
  made them, ``geom`` a ``pair.Geometry``;
* optionally ``outputs_lower``, the same in the nearest lower precision:
  the control (``control.py``).

The stages every reference shares -- the cadence and the fold -- judge
only what ``SHARED`` lists.  A configuration that its reference does not
cover stops at set-up (``spec.SetupError``, naming each key it lacks),
before the ring is made: it is never judged against another model's
outputs after a run.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import re
from pathlib import Path
from typing import Callable, List, Optional

from portbench import spec

DIR = Path(__file__).resolve().parent
DEFAULT = "pair"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_-]{0,63}$")
# the cadence (``cadence.py``) at the normal speed, the fold "nearest",
# and the radius as configured: the controller's radius walk reads
# timings, which no reference can follow
SHARED = {"cut_policy": ("nearest",), "playback_speed": (1.0,),
          "auto_quality": (False,)}


@dataclasses.dataclass(frozen=True)
class Reference:
    name: str
    outputs: Callable
    lower: Optional[Callable]     # the control's, where the module has one


def load(name: str):
    """The module of reference `name`: ``pair`` is ``pair.py`` as
    imported; any other is ``<DIR>/<name>.py`` loaded from its file."""
    if name == DEFAULT:
        from portbench.reference import pair
        return pair
    path = DIR / f"{name}.py"
    if not NAME.match(name) or not path.is_file():
        raise spec.SetupError(f"no reference {name!r} ({path} not found)")
    module_spec = importlib.util.spec_from_file_location(
        "portbench_reference_" + name.replace("-", "_"), path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def missing(covers: dict, cfg: dict) -> List[str]:
    """Each key whose value in `cfg` `covers` does not list."""
    return [f"{k}={cfg.get(k)!r} (covers {list(v)})"
            for k, v in covers.items() if cfg.get(k) not in v]


def for_config(cfg: dict) -> Reference:
    """The pair reference that judges configuration `cfg` (every field of
    the engine's configuration filled in); a ``spec.SetupError`` where it
    does not cover `cfg`."""
    name = cfg.get("reference", DEFAULT)
    module = load(name)
    gaps = missing(SHARED, cfg) + missing(module.COVERS, cfg)
    if gaps:
        raise spec.SetupError(f"reference {name!r} does not cover this "
                              f"configuration: {'; '.join(gaps)}")
    return Reference(name, module.outputs,
                     getattr(module, "outputs_lower", None))
