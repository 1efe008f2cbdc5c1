"""Config files, profiles, watch-later resume and the CLI's flag surface of
the port on the CPU: the analogs of the JAX package's
``tests/test_options.py`` (with ``TestShippedExample`` on
``examples/mfi.conf``) and ``test_api_ipc.py::TestResume``; the copies
(``options``, ``pipeline/resume``) held against their originals on the
same inputs; every option string of the JAX CLI's parser parsed by the
port's, with the same choices and values; and the port's CLI against the
JAX CLI's bytes under a config file with a profile and from a resumed
watch-later position (two JAX engine runs, 64x48); and the CLI's
--script and --interactive runs."""

import argparse
import functools
import os

import pytest
import torch

from mpv_frame_interpolator_tpu import cli as jax_cli
from mpv_frame_interpolator_tpu import options as jax_options
from mpv_frame_interpolator_tpu.pipeline import resume as jax_resume
from mpv_frame_interpolator_tpu_torch import __version__
from mpv_frame_interpolator_tpu_torch import cli as port_cli
from mpv_frame_interpolator_tpu_torch.api import Player
from mpv_frame_interpolator_tpu_torch.cli import build_parser
from mpv_frame_interpolator_tpu_torch.io import synthetic
from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MWriter
from mpv_frame_interpolator_tpu_torch.options import (
    ConfigError, parse_config_text, parse_with_config)
from mpv_frame_interpolator_tpu_torch.pipeline import resume
from mpv_frame_interpolator_tpu_torch.pipeline.engine import EngineConfig

torch.set_num_threads(1)

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "mfi.conf")


def parse(tmp_path, conf_text, argv):
    path = tmp_path / "mfi.conf"
    path.write_text(conf_text)
    return parse_with_config(build_parser(), ["--config", str(path)] + argv)


class TestParseText:
    def test_sections_and_comments(self):
        top, profiles = parse_config_text(
            "# comment\ndisplay-fps=60\n\n[fast]\nsearch-radius=5\n"
            "[hdr]\np010=yes\nmode='hsv'\n")
        assert top == {"display-fps": "60"}
        assert profiles["fast"] == {"search-radius": "5"}
        assert profiles["hdr"] == {"p010": "yes", "mode": "hsv"}

    def test_bad_line_rejected(self):
        with pytest.raises(ConfigError):
            parse_config_text("display-fps 60\n")

    def test_empty_profile_name_rejected(self):
        with pytest.raises(ConfigError):
            parse_config_text("[ ]\n")


class TestPrecedence:
    CONF = ("display-fps=50\nscene-threshold=25\n"
            "[fast]\nsearch-radius=7\ndisplay-fps=72\n"
            "[slow]\nsearch-radius=16\n")

    def test_file_overrides_defaults(self, tmp_path):
        args = parse(tmp_path, self.CONF, ["in.y4m"])
        assert args.display_fps == 50.0
        assert args.scene_threshold == 25.0
        assert args.search_radius == 5          # untouched default

    def test_profile_overrides_file(self, tmp_path):
        args = parse(tmp_path, self.CONF, ["--profile=fast", "in.y4m"])
        assert args.search_radius == 7
        assert args.display_fps == 72.0
        assert args.scene_threshold == 25.0     # file top level survives

    def test_cli_overrides_profile(self, tmp_path):
        args = parse(tmp_path, self.CONF,
                     ["--profile=fast", "--display-fps", "120", "in.y4m"])
        assert args.display_fps == 120.0
        assert args.search_radius == 7

    def test_profiles_apply_in_order(self, tmp_path):
        args = parse(tmp_path, self.CONF,
                     ["--profile=fast", "--profile=slow", "in.y4m"])
        assert args.search_radius == 16         # later profile wins
        assert args.display_fps == 72.0         # earlier profile survives

    def test_no_config_skips_file(self, tmp_path, monkeypatch):
        path = tmp_path / "mfi.conf"
        path.write_text(self.CONF)
        monkeypatch.setenv("MFI_CONF", str(path))
        args = parse_with_config(build_parser(), ["in.y4m"])
        assert args.display_fps == 50.0         # $MFI_CONF is read
        args = parse_with_config(build_parser(), ["--no-config", "in.y4m"])
        assert args.display_fps == 60.0         # built-in default


class TestBadInput:
    def test_unknown_key(self, tmp_path):
        with pytest.raises(ConfigError):
            parse(tmp_path, "not-an-option=1\n", ["in.y4m"])

    def test_bad_value(self, tmp_path):
        with pytest.raises(ConfigError):
            parse(tmp_path, "display-fps=fast\n", ["in.y4m"])

    def test_bad_bool(self, tmp_path):
        with pytest.raises(ConfigError):
            parse(tmp_path, "untimed=sometimes\n", ["in.y4m"])

    def test_bool_flag_values(self, tmp_path):
        args = parse(tmp_path, "untimed=yes\np010=no\n", ["in.y4m"])
        assert args.untimed is True
        assert args.p010 is False

    def test_unknown_profile(self, tmp_path):
        with pytest.raises(ConfigError):
            parse(tmp_path, "[a]\nuntimed=yes\n",
                  ["--profile=missing", "in.y4m"])

    def test_missing_explicit_config(self, tmp_path):
        with pytest.raises(ConfigError):
            parse_with_config(build_parser(),
                              ["--config", str(tmp_path / "nope.conf"),
                               "in.y4m"])

    def test_choice_key_validated(self, tmp_path):
        with pytest.raises(ConfigError):
            parse(tmp_path, "ingest=cuda\n", ["in.y4m"])


class TestShippedExample:
    def test_baseline_profiles_parse(self, tmp_path):
        conf = open(EXAMPLE).read()
        _, profiles = parse_config_text(conf)
        assert {"baseline-1", "baseline-2", "baseline-3", "baseline-4",
                "baseline-5"} <= set(profiles)
        # every profile maps onto the port's CLI as onto the JAX CLI's
        for name in sorted(profiles):
            argv = ["--config", EXAMPLE, f"--profile={name}", "in.y4m"]
            port = vars(parse_with_config(build_parser(), argv))
            ref = vars(jax_options.parse_with_config(jax_cli.build_parser(),
                                                     argv))
            assert {k: v for k, v in port.items() if k in ref} == \
                {k: v for k, v in ref.items() if k in port}, name

    def test_baseline_4_reproduces_config(self):
        args = parse_with_config(
            build_parser(),
            ["--config", EXAMPLE, "--profile=baseline-4", "in.y4m"])
        assert args.p010 is True and args.mode == "hsv"
        assert (args.width, args.height) == (3840, 2160)


CONF_TEXTS = [
    "# c\ndisplay-fps=60\n\n[fast]\nsearch-radius=5\n[hdr]\np010=yes\n"
    "mode='hsv'\n",
    "a = \"quoted value\"\n[p]\n  b=1=2\n[p]\nc=3\n",
    "x=1\n[]\n",
    "novalue\n",
    "=1\n",
]


@pytest.mark.parametrize("text", CONF_TEXTS)
def test_parse_config_text_copy_equals_the_original(text):
    try:
        want = jax_options.parse_config_text(text)
    except SystemExit as e:
        with pytest.raises(ConfigError) as got:
            parse_config_text(text)
        assert str(got.value) == str(e)
    else:
        assert parse_config_text(text) == want


# --- the flag surface ---------------------------------------------------------

def _options(parser):
    return {s: a for a in parser._actions for s in a.option_strings}


JAX_OPTIONS = _options(jax_cli.build_parser())
# a value each option takes (options with choices take each choice)
VALUES = {int: "3", float: "2.5"}
STRINGS = {"--mode": "grey", "--model": "hopperx", "--layer-buckets": "5,8",
           "--degrade-rungs": "2:2,3:4:blend", "--vf": "vflip"}


@pytest.mark.parametrize("opt", sorted(JAX_OPTIONS))
def test_every_jax_option_parses_on_the_port(opt, capsys):
    """Each option string of the JAX CLI's parser (with the config
    flags) is an option of the port's parser, with the same choices, and
    parses to the same value."""
    ref, port = JAX_OPTIONS[opt], _options(build_parser()).get(opt)
    assert port is not None, f"the port's CLI lacks {opt}"
    assert port.dest == ref.dest and port.nargs == ref.nargs
    if ref.choices is not None:
        assert list(port.choices) == list(ref.choices)
    if isinstance(ref, (argparse._HelpAction, argparse._VersionAction)):
        with pytest.raises(SystemExit) as e:
            build_parser().parse_args(["in.y4m", opt])
        assert e.value.code == 0
        out = capsys.readouterr().out
        if opt == "--version":
            assert out == f"mpv_frame_interpolator_tpu_torch {__version__}\n"
        else:
            assert "--device" in out
        return
    if ref.nargs == 0:
        values = [[]]
    elif ref.choices is not None:
        values = [[c] for c in ref.choices]
    else:
        values = [[VALUES.get(ref.type, STRINGS.get(opt, "x"))]]
    for value in values:
        argv = ["in.y4m", opt, *value]
        got = getattr(build_parser().parse_args(argv), ref.dest)
        assert got == getattr(jax_cli.build_parser().parse_args(argv),
                              ref.dest), argv


def test_the_flags_of_the_jax_cli_are_all_covered():
    """The parametrized test above covers every JAX option, config flags
    included (more cases than the refusals it replaces)."""
    assert {"--config", "--no-config", "--profile", "--version",
            "--ipc-server", "--applet-fifo", "--script", "--interactive",
            "--input-conf", "--no-input-default-bindings", "--profile-dir",
            "--save-position-on-quit", "--save-position-interval",
            "--no-resume", "--precompile", "--warp-loop",
            "--timing-source"} <= set(JAX_OPTIONS)
    assert len(JAX_OPTIONS) > 40


# --- watch-later ---------------------------------------------------------------

class TestResume:
    def test_roundtrip(self, tmp_path):
        d = str(tmp_path / "wl")
        path = resume.save("/media/movie.mkv", 123.456,
                           {"speed": 2.0, "search-radius": 9}, d)
        assert os.path.exists(path)
        state = resume.load("/media/movie.mkv", d)
        assert state["start"] == pytest.approx(123.456)
        assert state["speed"] == 2.0
        assert state["search-radius"] == 9
        p = Player(EngineConfig(scene_detection=False, auto_quality=False,
                                measure_timing=False, device="cpu"))
        pos = resume.apply_to_player(p, state)
        assert pos == pytest.approx(123.456)
        assert p.get_property("speed") == 2.0
        assert p.get_property("search-radius") == 9
        resume.forget("/media/movie.mkv", d)
        assert resume.load("/media/movie.mkv", d) is None

    def test_missing_is_none(self, tmp_path):
        assert resume.load("/nope.mkv", str(tmp_path)) is None

    def test_default_directory_follows_the_module(self, tmp_path,
                                                  monkeypatch):
        assert resume.DEFAULT_DIR == jax_resume.DEFAULT_DIR
        monkeypatch.setattr(resume, "DEFAULT_DIR", str(tmp_path))
        path = resume.save("clip.y4m", 1.5, {})
        assert os.path.dirname(path) == str(tmp_path)
        assert resume.load("clip.y4m")["start"] == 1.5


@pytest.mark.parametrize("props", [
    {"speed": 2.0, "search-radius": 9},
    {"speed": 1.25, "frame-output-mode": 3, "search-radius": 16,
     "black-level": 16.0, "white-level": 235.0, "scene-threshold": 12.5,
     "not-saved": 1}])
def test_resume_copy_reads_and_writes_the_originals_files(tmp_path, props):
    """Either package loads what the other saved, with the same key."""
    d = str(tmp_path)
    for save, load in ((resume.save, jax_resume.load),
                       (jax_resume.save, resume.load)):
        save("/media/a b.y4m", 42.125, props, d)
        assert load("/media/a b.y4m", d) == \
            jax_resume.load("/media/a b.y4m", d)
        assert load("/media/a b.y4m", d)["start"] == 42.125
    assert resume._key("x.y4m") == jax_resume._key("x.y4m")


# --- the CLI against the JAX CLI ------------------------------------------------

COMMON = ["--untimed", "--display-fps", "60", "--frames", "0"]


def _clip(path, n=12):
    cfg = synthetic.SyntheticConfig(width=64, height=48)
    with open(path, "wb") as fh:
        w = Y4MWriter(fh, 64, 48, 24.0)
        for f in synthetic.moving_box(cfg, n):
            w.write(f)
    return str(path)


def test_cli_config_profile_writes_the_jax_bytes(tmp_path, monkeypatch):
    """A config file with a top level and a profile: both CLIs write the
    same bytes, and so does the port with the flags written out."""
    monkeypatch.delenv("MFI_CONF", raising=False)
    src = _clip(tmp_path / "in.y4m")
    conf = tmp_path / "mfi.conf"
    conf.write_text("no-auto-quality=yes\nsearch-radius=7\n"
                    "[tv]\nblack-level=16\nwhite-level=235\n"
                    "delta-scalar=5\nscene-threshold=20\n")
    outs = []
    for tag, main, extra in (
            ("jax", jax_cli.main, ["--config", str(conf), "--profile=tv",
                                   "--no-resume"]),
            ("port", port_cli.main, ["--config", str(conf), "--profile=tv",
                                     "--device", "cpu"]),
            ("flags", port_cli.main,
             ["--no-config", "--no-auto-quality", "--search-radius", "7",
              "--black-level", "16", "--white-level", "235",
              "--delta-scalar", "5", "--scene-threshold", "20",
              "--device", "cpu"])):
        out = tmp_path / f"{tag}.y4m"
        assert main([src, *COMMON, *extra, "-o", str(out)]) == 0, tag
        outs.append(out.read_bytes())
    assert outs[0].count(b"FRAME") > 12
    assert outs[1] == outs[0]
    assert outs[2] == outs[0]


def test_cli_resumes_a_saved_position_as_the_jax_cli(tmp_path, monkeypatch):
    """The port saves a watch-later position on quit; the JAX CLI and the
    port resume it (knobs and position) and write the same bytes, which
    are those of a --start run at that position."""
    wl = str(tmp_path / "wl")
    monkeypatch.setattr(resume, "DEFAULT_DIR", wl)
    for name in ("load", "save"):
        monkeypatch.setattr(jax_resume, name, functools.partial(
            getattr(jax_resume, name), directory=wl))
    src = _clip(tmp_path / "in.y4m", 16)
    base = [src, "--no-auto-quality", *COMMON]
    assert port_cli.main([*base[:-2], "--frames", "6",
                          "--save-position-on-quit", "--white-level", "235",
                          "--device", "cpu",
                          "-o", str(tmp_path / "first.y4m")]) == 0
    state = resume.load(src)
    assert state == jax_resume.load(src)
    assert 0.1 < state["start"] < 0.3 and state["white-level"] == 235.0
    outs = []
    for tag, main, extra in (("jax", jax_cli.main, []),
                             ("port", port_cli.main, ["--device", "cpu"]),
                             ("start", port_cli.main,
                              ["--no-resume", "--start", str(state["start"]),
                               "--white-level", "235", "--device", "cpu"])):
        out = tmp_path / f"{tag}.y4m"
        assert main([*base, *extra, "-o", str(out)]) == 0, tag
        outs.append(out.read_bytes())
    assert 0 < outs[0].count(b"FRAME") < 40
    assert outs[1] == outs[0]
    assert outs[2] == outs[0]


@pytest.mark.parametrize("case", ["script", "failing-script", "interactive"])
def test_cli_script_and_keys(tmp_path, case):
    """--script runs on a thread with `player` and `pipeline` bound (a
    failure is logged and counted, playback goes on); --interactive with an
    input.conf runs to the end with or without a terminal."""
    import json
    src = _clip(tmp_path / "in.y4m", 6)
    marker = tmp_path / "marker.json"
    extra = []
    if case == "interactive":
        conf = tmp_path / "input.conf"
        conf.write_text("x set speed 2\n")
        extra = ["--interactive", "--input-conf", str(conf),
                 "--no-input-default-bindings"]
    else:
        script = tmp_path / "s.py"
        body = ("import json\n"
                f"json.dump([player.property_names(), "
                f"pipeline.source is not None], open({str(marker)!r}, 'w'))\n")
        if case == "failing-script":
            body += "raise RuntimeError('a script bug')\n"
        script.write_text(body)
        extra = ["--script", str(script)]
    stats = tmp_path / "stats.json"
    assert port_cli.main([src, *COMMON, "--no-resume", "--device", "cpu",
                          *extra, "-o", str(tmp_path / "out.y4m"),
                          "--dump-stats", str(stats)]) == 0
    got = json.loads(stats.read_text())
    assert got["engine_failures"] == 0
    assert got["control_failures"] == (1 if case == "failing-script" else 0)
    assert got["frames_in"] == 6
    if case != "interactive":
        names, bound = json.loads(marker.read_text())
        assert names == Player(EngineConfig(device="cpu")).property_names()
        assert bound
