"""Layered INI + environment configuration, the port's own copy.

Same behaviour as `deepfilternet_tpu.config`: a process-global `Config`
backed by an INI file, where `config(option, default, cast, section)` reads,
in priority order, (1) an `OPTION`-named environment variable, (2) the INI
value, (3) the default, which is written back so a saved config.ini is
self-documenting. The defaults of `DfParams` (and of the model sections that
build on it) must equal the JAX package's exactly: a model directory with an
empty config.ini is configured by them alone.
"""

from __future__ import annotations

import configparser
import io
import os
import random
import string
from typing import Any, Callable, List, Optional, Type, Union

_CONFIG_TRUE = ("true", "yes", "y", "1", "on")
_CONFIG_FALSE = ("false", "no", "n", "0", "off")


class CsvType:
    """Cast a comma-separated string to a tuple of `inner` values."""

    def __init__(self, inner: Callable[[str], Any] = str):
        self.inner = inner

    def __call__(self, value: Union[str, tuple, list]) -> tuple:
        if isinstance(value, (tuple, list)):
            return tuple(self.inner(v) if isinstance(v, str) else v for v in value)
        items = [v.strip() for v in str(value).split(",") if v.strip() != ""]
        return tuple(self.inner(v) for v in items)

    def to_str(self, value) -> str:
        if isinstance(value, (tuple, list)):
            return ",".join(str(v) for v in value)
        return str(value)


# the reference's public name
Csv = CsvType


def _cast_bool(v: Union[str, bool]) -> bool:
    if isinstance(v, bool):
        return v
    vl = str(v).strip().lower()
    if vl in _CONFIG_TRUE:
        return True
    if vl in _CONFIG_FALSE:
        return False
    raise ValueError(f"Cannot interpret {v!r} as bool")


class Config:
    """INI sections with typed reads, environment override and default
    write-back; `save()` writes the file with every default read so far."""

    def __init__(self):
        self.reset()

    def load(self, path: Optional[str], allow_defaults: bool = True,
             allow_reload: bool = False):
        if self.path is not None and not allow_reload:
            raise ValueError("Config already loaded")
        self.parser = configparser.ConfigParser(interpolation=None)
        self.allow_defaults = allow_defaults
        if path is not None and os.path.isfile(path):
            self.parser.read(path)
            self._migrate_legacy_sections()
        self.path = path if path is not None else self.path

    def _migrate_legacy_sections(self):
        # old configs name the model section `clc`
        if self.parser.has_section("clc") and not self.parser.has_section("deepfilternet"):
            self.parser.add_section("deepfilternet")
            for k, v in self.parser.items("clc"):
                self.parser.set("deepfilternet", k, v)
            self.parser.remove_section("clc")

    def use_defaults(self):
        self.load(path=None, allow_defaults=True, allow_reload=True)

    def reset(self):
        self.parser = configparser.ConfigParser(interpolation=None)
        self.path: Optional[str] = None
        self.allow_defaults = True

    def save(self, path: Optional[str] = None):
        path = path or self.path
        if path is None:
            raise ValueError("No config path provided")
        with open(path, "w") as f:
            self.parser.write(f)

    def get(self, option: str, default: Any = None, cast: Type = str,
            section: str = "DF", save: bool = True) -> Any:
        section_l = section.lower()
        option_l = option.lower()
        raw: Optional[str] = os.environ.get(option.upper())
        if raw is None:
            for sec in self.parser.sections():
                if sec.lower() == section_l and self.parser.has_option(sec, option_l):
                    raw = self.parser.get(sec, option_l)
                    break
        if raw is None:
            if default is None and not self.allow_defaults:
                raise KeyError(f"Option {option} not found in section {section}")
            value = default
        else:
            value = _cast_bool(raw) if cast is bool else cast(raw)
        if save and raw is None and default is not None:
            self.set(option, value, cast=cast, section=section)
        return value

    def set(self, option: str, value: Any, cast: Type = str, section: str = "DF"):
        sec = next((s for s in self.parser.sections()
                    if s.lower() == section.lower()), None)
        if sec is None:
            sec = section
            self.parser.add_section(sec)
        self.parser.set(sec, option.lower(),
                        cast.to_str(value) if isinstance(cast, CsvType) else str(value))

    def sections(self) -> List[str]:
        return list(self.parser.sections())

    def tostr(self) -> str:
        buf = io.StringIO()
        self.parser.write(buf)
        return buf.getvalue()


_config = Config()


def config(option: str, default: Any = None, cast: Type = str,
           section: str = "DF", save: bool = True) -> Any:
    """Read one option; see the module docstring for the lookup order."""
    return _config.get(option, default=default, cast=cast, section=section, save=save)


config.load = _config.load  # type: ignore[attr-defined]
config.save = _config.save  # type: ignore[attr-defined]
config.use_defaults = _config.use_defaults  # type: ignore[attr-defined]
config.reset = _config.reset  # type: ignore[attr-defined]
config.set = _config.set  # type: ignore[attr-defined]
config.obj = _config  # type: ignore[attr-defined]


class DfParams:
    """Base DSP/model hyperparameters (section DF)."""

    section = "DF"

    def __init__(self):
        self.sr: int = config("SR", cast=int, default=48_000, section="DF")
        self.fft_size: int = config("FFT_SIZE", cast=int, default=960, section="DF")
        self.hop_size: int = config("HOP_SIZE", cast=int, default=480, section="DF")
        self.nb_erb: int = config("NB_ERB", cast=int, default=32, section="DF")
        self.nb_df: int = config("NB_DF", cast=int, default=96, section="DF")
        self.norm_tau: float = config("NORM_TAU", 1, float, section="DF")
        self.lsnr_max: int = config("LSNR_MAX", 35, int, section="DF")
        self.lsnr_min: int = config("LSNR_MIN", -15, int, section="DF")
        self.min_nb_freqs: int = config("MIN_NB_ERB_FREQS", 2, int, section="DF")
        self.df_order: int = config("DF_ORDER", cast=int, default=5, section="DF")
        self.df_lookahead: int = config("DF_LOOKAHEAD", cast=int, default=0, section="DF")
        self.pad_mode: str = config("PAD_MODE", default="input", section="DF")


def random_name(n: int = 6) -> str:
    return "".join(random.choices(string.ascii_lowercase, k=n))
