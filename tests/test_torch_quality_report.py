"""The port's quality report and degrade-ladder tool against the JAX
repository's ``tools/quality_report.py`` and ``tools/degrade_ladder.py``.

The JAX tool is imported by path and run on the CPU; its printed table
is captured and held against the port's rows at the printed 0.1 dB, and
for one blend position a column the port's rendered luma plane against
the JAX ``_warp_sample`` plane rendered the way the JAX tool renders it,
byte for byte.  The port runs its kernels' plain versions here."""

import ast
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu_torch.tools import degrade_ladder
from mpv_frame_interpolator_tpu_torch.tools import quality_report as port_qr

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(
        "jax_" + Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_qr():
    return _load("tools/quality_report.py")


@pytest.fixture(scope="module")
def port_reports():
    return {s: port_qr.report(s, "cpu", quiet=True) for s in port_qr.SHIFTS}


def _parse(text: str):
    """The printed table -> (column names, [(t, [dB...])], mean row)."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    names = re.split(r"\s{2,}", lines[1].strip())[1:]
    rows = []
    for ln in lines[2:]:
        head, *vals = ln.split()
        rows.append((head, [float(v[:-2]) for v in vals]))
    return names, rows


@pytest.mark.parametrize("shift", port_qr.SHIFTS)
def test_report_equals_the_jax_tool(capsys, jax_qr, port_reports, shift):
    jax_qr.report(shift)
    printed = capsys.readouterr().out
    names, rows = _parse(printed)
    assert names == list(port_qr.COLUMNS)
    rep = port_reports[shift]
    want = [(f"{t}", [round(v[n], 1) for n in names])
            for t, v in rep.capped()]
    want.append(("mean", [round(rep.mean()[n], 1) for n in names]))
    assert [h for h, _ in rows] == [h for h, _ in want]
    for (_, got_vals), (_, want_vals) in zip(rows, want):
        np.testing.assert_allclose(got_vals, want_vals, rtol=0, atol=0.051)
    # the port prints the JAX tool's table, character for character
    assert rep.table() + "\n" == printed
    # t = 0.5 at shift 6 is an exact hit for every flow family
    if shift == 6:
        exact = dict(rep.rows)[0.5]
        assert all(exact[n] == float("inf") for n in names[1:])


@pytest.fixture(scope="module")
def jax_fields(jax_qr):
    """The JAX tool's inputs and fields at shift 2.5, built as its
    ``report`` builds them."""
    import jax.numpy as jnp
    from mpv_frame_interpolator_tpu.ops.flow import (
        _subsampled_f2, blur_flow, subpel_refine)
    f1, f2, _ = jax_qr.sine_frames(2.5)
    m = jax_qr.HopperModel.for_frame(f1.fmt.height, f1.fmt.width,
                                     search_radius=10)
    a = [*jax_qr.planar(f1), *jax_qr.planar(f2)]
    off, blur = m.analyze(*a)
    frac_raw = subpel_refine(m.geom, off, a[0], a[1], a[2],
                             _subsampled_f2(m.geom, a[3], a[4], a[5]))
    b64 = blur_flow((off << 6) + frac_raw, m.geom.low_h, m.geom.low_w)
    blur_sub = b64 >> 6
    frac = b64 - (blur_sub << 6)
    return {"m": m, "a": a, "blur": blur, "blur_sub": blur_sub,
            "frac": frac, "zero": jnp.zeros_like(blur)}


def test_subpel_field_equals_the_jax_tool(jax_fields):
    """The port's one-launch sub-pel flow gives the JAX tool's blur_sub
    and frac, and its flow the JAX blurred field."""
    from mpv_frame_interpolator_tpu_torch.convert import frame_to_device
    from mpv_frame_interpolator_tpu_torch.models.hopper import HopperModel
    from mpv_frame_interpolator_tpu_torch.ops import flow as flow_ops
    f1, f2, _ = port_qr.sine_frames(2.5)
    m = HopperModel.for_frame(128, 256, search_radius=10, device="cpu")
    d1, d2 = frame_to_device(f1, "cpu"), frame_to_device(f2, "cpu")
    planar = (d1.y, d1.u, d1.v, d2.y, d2.u, d2.v)
    _, blur = m.analyze(*planar)
    _, b64 = flow_ops.flow(m.geom, *planar, 10, subpel=True)
    blur_sub = b64 >> 6
    np.testing.assert_array_equal(blur.numpy(),
                                  np.asarray(jax_fields["blur"]))
    np.testing.assert_array_equal(blur_sub.numpy(),
                                  np.asarray(jax_fields["blur_sub"]))
    np.testing.assert_array_equal((b64 - (blur_sub << 6)).numpy(),
                                  np.asarray(jax_fields["frac"]))
    assert m.geom.res_scalar == 0 and m.geom.low_h == 128


# the JAX tool's render of each column: (field, frac or None, kwargs)
_JAX_RENDER = {
    "blend (no flow)": ("zero", None, {}),
    "hopper": ("blur", None, {}),
    "hopperx": ("blur", None, {"occlusion_aware": True}),
    "hopperq": ("blur", None, {"bilinear": True}),
    "hopperxq": ("blur", None, {"bilinear": True, "occlusion_aware": True}),
    "hopperq+subpel": ("blur_sub", "frac", {"bilinear": True}),
    "hopperxq+subpel": ("blur_sub", "frac", {"bilinear": True,
                                             "occlusion_aware": True}),
}


@pytest.mark.parametrize("column", list(port_qr.COLUMNS))
def test_plane_equals_the_jax_render(jax_fields, port_reports, column):
    import jax.numpy as jnp
    from mpv_frame_interpolator_tpu.ops import warp as W
    t = port_qr.TS[list(port_qr.COLUMNS).index(column) % len(port_qr.TS)]
    field, frac, kw = _JAX_RENDER[column]
    g = jax_fields
    fields = W._warp_fields(g["m"].geom, g[field],
                            *([g[frac]] if frac else []))
    y, _, _ = W._warp_sample(
        g["m"].geom, W.BLENDED_FRAME, 0, jnp.uint8, *g["a"], fields,
        jnp.float32(t), jnp.float32(0.0), jnp.float32(255.0), **kw)
    want = np.asarray(y)[port_qr.CROP]
    got = port_reports[2.5].planes[(t, column)]
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_report_calls_each_familys_path(port_reports):
    """Every column ran its family's path of the engine (here the plain
    versions, one call a wrapper where the card launches its kernel)."""
    rep = port_reports[6]
    n = len(port_qr.TS)
    assert rep.launches["flow"] == {"plain:flow_step": 1,
                                    "plain:blur_flow": 1}
    assert rep.launches["flow+subpel"] == {
        "plain:flow_step": 1, "plain:blur_flow": 1,
        "plain:subpel_refine": 1}
    for col in ("blend (no flow)", "hopper"):
        assert rep.launches[col] == {"plain:pair_blend": n}
    assert rep.launches["hopperx"] == {"plain:sample_dir": 2 * n,
                                       "plain:blend_levels": n}
    for col in ("hopperq", "hopperxq", "hopperq+subpel", "hopperxq+subpel"):
        assert rep.launches[col] == {"plain:bilinear_blend": n}


def test_ladder_equals_the_jax_tool():
    tree = ast.parse((REPO / "tools" / "degrade_ladder.py").read_text())
    lists = [ast.literal_eval(node.value) for node in ast.walk(tree)
             if isinstance(node, ast.Assign)
             and any(getattr(t, "id", None) == "ladder"
                     for t in node.targets)]
    assert len(lists) == 1
    assert [tuple(r) for r in lists[0]] == degrade_ladder.LADDER


@pytest.mark.parametrize("tool", ["quality_report", "degrade_ladder"])
def test_tools_need_the_card(capsys, tool):
    """Both tools default to the card and never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    main = {"quality_report": port_qr.main,
            "degrade_ladder": degrade_ladder.main}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["64x48"] if tool == "degrade_ladder" else [])
    assert "ms/pair" not in capsys.readouterr().out
