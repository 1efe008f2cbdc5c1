"""Config files + profiles (the port's copy of the JAX package's
``options.py``: the same file, ``$MFI_CONF`` or
``~/.config/mfi_tpu/mfi.conf``, the same syntax and precedence; the m_config
frontend analog).

The reference layers option sources with fixed precedence: command line >
profiles applied by --profile > config-file top level > built-in defaults
(options/m_config_frontend.c:1091 config parsing, profile sections, and
the same key=value syntax as mpv.conf).  This module reproduces that for
the rebuild's argparse surface:

    # ~/.config/mfi_tpu/mfi.conf
    display-fps=60
    scene-threshold=25
    [hdr-4k]                      # profile: applied only with --profile
    p010=yes
    mode=hsv

    mfi input.y4m --profile=hdr-4k --display-fps=120
    #  -> display-fps 120 (CLI) / p010 + hsv (profile) / threshold 25 (file)

Keys are the CLI flag names without the leading dashes; booleans accept
yes/no/true/false/1/0.  Unknown keys and malformed values are hard errors
(the reference refuses to start on unknown options too).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Tuple

DEFAULT_PATH = os.path.expanduser("~/.config/mfi_tpu/mfi.conf")

_BOOL = {"yes": True, "true": True, "1": True, "on": True,
         "no": False, "false": False, "0": False, "off": False}


class ConfigError(SystemExit):
    def __init__(self, msg: str):
        super().__init__(f"config error: {msg}")


def parse_config_text(text: str, source: str = "<config>"
                      ) -> Tuple[Dict[str, str], Dict[str, Dict[str, str]]]:
    """-> (top-level key/values, {profile name: key/values})."""
    top: Dict[str, str] = {}
    profiles: Dict[str, Dict[str, str]] = {}
    current = top
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            name = line[1:-1].strip()
            if not name:
                raise ConfigError(f"{source}:{lineno}: empty profile name")
            current = profiles.setdefault(name, {})
            continue
        if "=" not in line:
            raise ConfigError(
                f"{source}:{lineno}: expected key=value, got {line!r}")
        key, val = line.split("=", 1)
        key, val = key.strip(), val.strip()
        # strip optional quotes (mpv.conf allows them)
        if len(val) >= 2 and val[0] == val[-1] and val[0] in "\"'":
            val = val[1:-1]
        if not key:
            raise ConfigError(f"{source}:{lineno}: empty option name")
        current[key] = val
    return top, profiles


def load_config_file(path: str):
    with open(path) as fh:
        return parse_config_text(fh.read(), source=path)


def _convert(parser: argparse.ArgumentParser, kv: Dict[str, str],
             source: str) -> Dict[str, object]:
    """Map config keys onto parser defaults, with the parser's own types."""
    actions = {}
    for a in parser._actions:
        for opt in a.option_strings:
            if opt.startswith("--"):
                actions[opt[2:]] = a
    out: Dict[str, object] = {}
    for key, val in kv.items():
        a = actions.get(key)
        if a is None or key in ("config", "no-config", "profile", "help",
                                "version"):
            raise ConfigError(f"{source}: unknown option {key!r}")
        if a.nargs == 0:    # store_true-style flag
            b = _BOOL.get(val.lower())
            if b is None:
                raise ConfigError(
                    f"{source}: option {key!r} wants yes/no, got {val!r}")
            out[a.dest] = b
        elif a.type is not None:
            try:
                out[a.dest] = a.type(val)
            except (TypeError, ValueError):
                raise ConfigError(
                    f"{source}: bad value for {key!r}: {val!r}") from None
        elif a.choices is not None and val not in a.choices:
            raise ConfigError(
                f"{source}: {key!r} must be one of {sorted(a.choices)}, "
                f"got {val!r}")
        else:
            out[a.dest] = val
    return out


def add_config_flags(parser: argparse.ArgumentParser):
    parser.add_argument("--config", default="",
                        help=f"config file path (default {DEFAULT_PATH}, "
                             "or $MFI_CONF)")
    parser.add_argument("--no-config", action="store_true",
                        help="ignore any config file")
    parser.add_argument("--profile", action="append", default=[],
                        metavar="NAME",
                        help="apply a [NAME] profile section from the "
                             "config file (repeatable, applied in order)")


def parse_with_config(parser: argparse.ArgumentParser,
                      argv: List[str] = None) -> argparse.Namespace:
    """parse_args with config-file layering: CLI > profile(s) > file top
    level > parser defaults."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default="")
    pre.add_argument("--no-config", action="store_true")
    pre.add_argument("--profile", action="append", default=[])
    pre_ns, _ = pre.parse_known_args(argv)

    path = pre_ns.config or os.environ.get("MFI_CONF", DEFAULT_PATH)
    if not pre_ns.no_config:
        explicit = bool(pre_ns.config)
        if os.path.exists(path):
            top, profiles = load_config_file(path)
            merged = dict(top)
            for name in pre_ns.profile:
                if name not in profiles:
                    raise ConfigError(
                        f"{path}: no profile {name!r} "
                        f"(available: {sorted(profiles) or 'none'})")
                merged.update(profiles[name])
            parser.set_defaults(**_convert(parser, merged, path))
        elif explicit:
            raise ConfigError(f"config file not found: {path}")
        elif pre_ns.profile:
            raise ConfigError(
                f"--profile given but no config file at {path}")
    elif pre_ns.profile:
        raise ConfigError("--profile conflicts with --no-config")
    return parser.parse_args(argv)
