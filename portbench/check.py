"""How ``correct`` is decided: the program's outputs of the timed path
against the plain reference (``reference/``), after the window.

* the cadence: every call of the window emitted the pts the reference
  cadence gives its frames, in order (``cadence_errors``, a count of
  outputs, limit 0);
* the cut: the program's device count of folded cuts equals the number
  of pairs that the reference finds to be cuts among all the pairs the
  run processed (``cut_count_error``, limit 0);
* the pixels: for a sample of the window's pairs drawn from the seed --
  with pairs across a change of shot in it, and the window's last pair --
  every sample of every output equals the reference's
  (``samples_differing``, limit 0); an output the program never emitted
  counts all its samples (``outputs_missing``, limit 0).  At least
  ``MIN_PAIRS`` pairs, one of them across a cut, have to be compared.

The reference reads only the source planes the benchmark made.  Which
reference makes a configuration's outputs is ``reference.models``'s
choice, by the configuration; the cut, the fold and the cadence are
shared.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference import cadence as ref_cadence
from portbench.reference import models as ref_models
from portbench.reference import pair as ref

MIN_PAIRS = 3
MIN_CUT_PAIRS = 1


def sample_frames(seed: int, first: int, params: dict,
                  shot_len: int) -> List[int]:
    """Stream indices of the sampled pairs' newer frames: `pairs` drawn
    from the window's first `from_first` pairs, and for `cut_pairs` more
    draws the first pair across a change of shot at or after it."""
    rng = np.random.default_rng([int(seed), 0x73616D70])
    span = int(params["from_first"])
    picks = {first + int(i) for i in rng.choice(
        span, size=min(int(params["pairs"]), span), replace=False)}
    for a in rng.integers(0, max(span - shot_len, 1),
                          size=int(params["cut_pairs"])):
        f = first + int(a)
        picks.add(f + (-f) % shot_len)
    return sorted(picks)


@dataclasses.dataclass
class Verdict:
    checks: Dict[str, dict]
    failed: int
    correct: bool


def _check(value, limit, at_least: bool = False) -> dict:
    ok = value >= limit if at_least else value <= limit
    return {"value": value, "limit": limit,
            "op": ">=" if at_least else "<=", "ok": bool(ok)}


def cadence_errors(calls, plan) -> (int, int):
    """(outputs whose pts differ from the reference's, calls with any)."""
    errors = bad_calls = 0
    for c in calls:
        want = [p for f in range(c.first, c.first + c.frames)
                for p, _ in (plan[f] or ())]
        got = list(c.pts)
        n = sum(1 for a, b in zip(got, want) if a != b)
        n += abs(len(got) - len(want))
        errors += n
        bad_calls += n > 0
    return errors, bad_calls


def transition_cuts(ring, geom: ref.Geometry, scale_shift: int,
                    threshold: float, enabled: bool) -> List[bool]:
    """Whether the pair ring[i - 1] -> ring[i] is a cut, for every i."""
    n = len(ring)
    return [enabled and ref.is_cut(ref.cut_score(
        ring[(i - 1) % n][0], ring[i][0], geom.rs, scale_shift), threshold)
        for i in range(n)]


def expected_cuts(cuts: Sequence[bool], frames: int) -> int:
    """Cuts among the pairs ending at frames 1 .. frames - 1."""
    n = len(cuts)
    full, rest = divmod(frames - 1, n)
    return full * sum(cuts) + sum(cuts[(1 + k) % n] for k in range(rest))


@dataclasses.dataclass
class PixelResult:
    differing: int = 0
    missing_outputs: int = 0
    pairs: int = 0
    cut_pairs: int = 0
    wrong_pairs: int = 0


def compare_outputs(ring, cfg: dict, geom: ref.Geometry, plan,
                    outputs: Dict[int, list], cuts: Sequence[bool],
                    scale_shift: int, levels) -> PixelResult:
    """Each sampled frame's outputs (objects with ``pts`` and
    ``device_planes()``) against the outputs of its pair that the
    configuration's reference (``reference.models.for_config``) makes;
    `cfg` has every field of the engine's configuration."""
    reference = ref_models.for_config(cfg)
    n = len(ring)
    res = PixelResult()
    for frame in sorted(outputs):
        want = plan[frame] or []
        got = {o.pts: o for o in outputs[frame]}
        f1, f2 = ring[(frame - 1) % n], ring[frame % n]
        folded = ref.prologue(f1, f2, geom, [b for _, b in want],
                              scale_shift, bool(cfg["scene_detection"]),
                              float(cfg["scene_threshold"]))
        made = iter(reference.outputs(f1, f2, geom, folded, cfg,
                                      scale_shift, levels))
        wrong = 0
        for pts, _ in want:
            ry, ruv = next(made)
            o = got.get(pts)
            if o is None:
                res.missing_outputs += 1
                wrong += ry.numel() + ruv.numel()
                continue
            gy, guv = o.device_planes()
            for g, r in ((gy, ry), (guv, ruv)):
                if tuple(g.shape) != tuple(r.shape):
                    wrong += r.numel()
                else:
                    wrong += int((g.to(torch.int64) != r).sum())
        res.differing += wrong
        res.wrong_pairs += wrong > 0
        res.pairs += 1
        res.cut_pairs += cuts[frame % n]
    return res


def judge(ring, cfg: dict, geom: ref.Geometry, plan, calls,
          outputs: Dict[int, list], cuts: Sequence[bool],
          program_cuts: Optional[int], frames: int, scale_shift: int,
          levels) -> Verdict:
    """The verdict of a run, with each number compared beside its limit."""
    cad_errors, cad_calls = cadence_errors(calls, plan)
    px = compare_outputs(ring, cfg, geom, plan, outputs, cuts, scale_shift,
                         levels)
    want_cuts = expected_cuts(cuts, frames)
    cut_error = (abs(program_cuts - want_cuts) if program_cuts is not None
                 else want_cuts + 1)
    checks = {
        "samples_differing": _check(px.differing, 0),
        "outputs_missing": _check(px.missing_outputs, 0),
        "cadence_errors": _check(cad_errors, 0),
        "cut_count_error": _check(cut_error, 0),
        "pairs_compared": _check(px.pairs, MIN_PAIRS, at_least=True),
        "cut_pairs_compared": _check(px.cut_pairs, MIN_CUT_PAIRS,
                                     at_least=True),
    }
    return Verdict(checks, px.wrong_pairs + cad_calls,
                   all(c["ok"] for c in checks.values()))


def plan_for(frames: int, cfg: dict):
    return ref_cadence.plan(frames, float(cfg["source_fps"]),
                            float(cfg["display_fps"]))
