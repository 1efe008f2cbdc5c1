"""The engine under ``subpel_flow=True`` for the integer families hopper
and hopperx against the JAX engine (which take the sub-pel field as a
flow rounded to the nearest pel), and ``--subpel-flow`` through the
port's CLI writing the JAX CLI's bytes.  The sub-pel kernels' plain
versions and the bilinear families: ``tests/test_torch_subpel.py``.
Bit-exact (tolerance 0)."""

import pytest
import torch

from mpv_frame_interpolator_tpu import cli as jax_cli
from mpv_frame_interpolator_tpu_torch import cli as port_cli

from test_torch_subpel import check_subpel_engine

torch.set_num_threads(1)


@pytest.mark.parametrize("model,pixfmt,levels", [
    ("hopper", "p010", (16.0, 235.0)), ("hopperx", "nv12", (0.0, 255.0))])
def test_engine_subpel_equals_jax(model, pixfmt, levels):
    check_subpel_engine(model, pixfmt, levels)


def test_cli_subpel_flow_bytes(tmp_path):
    """--subpel-flow with hopperq, and the ladder and bucket flags set
    off their defaults (auto-quality off, so the run is deterministic):
    the JAX CLI's bytes."""
    argv = ["synthetic:moving_box", "--width", "64", "--height", "48",
            "--frames", "5", "--untimed", "--no-auto-quality",
            "--display-fps", "48", "--model",
            "hopperq", "--subpel-flow", "--search-radius", "7",
            "--layer-buckets", "4,12", "--degrade-rungs", "1:2,3:4:repeat"]
    jax_out, port_out = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    assert jax_cli.main(argv + ["-o", str(jax_out)]) == 0
    assert port_cli.main(argv + ["--device", "cpu", "-o",
                                 str(port_out)]) == 0
    data = port_out.read_bytes()
    assert data.count(b"FRAME\n") == 1 + 2 * 4
    assert data == jax_out.read_bytes()
