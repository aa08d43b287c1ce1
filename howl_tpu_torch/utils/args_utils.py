"""Thin argparse helpers (counterpart of ``howl_tpu/utils/args_utils.py``;
capability parity: howl/utils/args_utils.py:34) plus the string-to-bool
flag parser (ref howl/utils/str_utils.py:4 — the reference wraps
distutils.strtobool, removed in Python 3.12)."""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

_TRUE = {"y", "yes", "t", "true", "on", "1"}
_FALSE = {"n", "no", "f", "false", "off", "0"}


def strtobool(bool_str: str) -> bool:
    """True for y/yes/t/true/on/1, False for n/no/f/false/off/0 (any case);
    raises ValueError otherwise — the reference's argparse flag convention."""
    v = bool_str.lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"invalid truth value {bool_str!r}")


@dataclass
class ArgOption:
    """One argparse option: positional names + keyword config."""

    names: Tuple[str, ...]
    kwargs: Dict[str, Any] = field(default_factory=dict)


def opt(*names, **kwargs) -> ArgOption:
    return ArgOption(names, kwargs)


class ArgumentParserBuilder:
    """Accumulates options, builds a parser; mirrors reference ergonomics."""

    def __init__(self, **parser_kwargs):
        self.parser = argparse.ArgumentParser(**parser_kwargs)

    def add_options(self, *options: ArgOption) -> "ArgumentParserBuilder":
        for option in options:
            self.parser.add_argument(*option.names, **option.kwargs)
        return self

    def build(self) -> argparse.ArgumentParser:
        return self.parser
