"""Three-tier configuration/flag system: enum defaults < properties file < CLI.

Re-creation of the reference's ``utils/Config`` semantics
(``src/edu/umass/cs/utils/Config.java:15``, ``getGlobal*`` at 226-343,
``Config.register(args)`` used from ``PaxosServer.main:140``): flags are
declared as enum members carrying their default value; a properties file
(named by the ``GIGAPAXOS_CONFIG`` env var or ``-DgigapaxosConfig=...``-style
CLI arg, default ``gigapaxos.properties``) overrides defaults; explicit
``key=value`` CLI args / programmatic overrides take highest precedence.

Node addresses use the reference's scheme (``SURVEY.md`` §5): lines of the
form ``active.NAME=host:port`` and ``reconfigurator.NAME=host:port``.
"""

from __future__ import annotations

import enum
import os
import threading
from typing import Any, Dict, Iterable, Optional, Tuple, Type

_TRUE = frozenset(("true", "1", "yes", "on"))
_FALSE = frozenset(("false", "0", "no", "off"))


class FlagEnum(enum.Enum):
    """Flag enum whose members carry their DEFAULT without enum aliasing.

    A plain ``enum.Enum`` treats members with equal values as ALIASES of
    one member — ``BATCHING_ENABLED = True`` and ``ENABLE_JOURNALING =
    True`` would be the SAME flag, so overriding one silently overrode
    every equal-valued sibling (this bit for real: setting
    ``BATCHING_ENABLED=false`` turned journaling off).  Members here get
    a unique ordinal ``value`` and keep the declared default in
    ``.default``."""

    def __new__(cls, default):
        obj = object.__new__(cls)
        obj._value_ = len(cls.__members__)  # unique ordinal: never aliases
        obj.default = default
        return obj


def flag_default(member: Any) -> Any:
    """The declared default of a flag member (FlagEnum or plain enum)."""
    return getattr(member, "default", member.value)


def _coerce(raw: str, default: Any) -> Any:
    """Coerce a string property to the type of the enum default."""
    if isinstance(default, bool):
        low = raw.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError(f"cannot parse boolean from {raw!r}")
    if isinstance(default, int) and not isinstance(default, bool):
        return int(raw, 0)
    if isinstance(default, float):
        return float(raw)
    return raw


def parse_properties(text: str) -> Dict[str, str]:
    """Parse a java-style .properties file body into a dict."""
    props: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or line.startswith("!"):
            continue
        for sep in ("=", ":"):
            if sep in line:
                key, _, val = line.partition(sep)
                props[key.strip()] = val.strip()
                break
    return props


class Config:
    """Global registry of flag enums with three-tier override resolution."""

    _lock = threading.RLock()
    _defaults: Dict[str, Any] = {}  # "EnumClassName.MEMBER" and bare "MEMBER"
    _file_props: Dict[str, str] = {}
    _cli: Dict[str, str] = {}
    _registered: Dict[str, Type[enum.Enum]] = {}

    # ---- registration -------------------------------------------------
    @classmethod
    def register(cls, flag_enum: Type[enum.Enum]) -> None:
        """Register a flag enum whose member values are the defaults."""
        with cls._lock:
            cls._registered[flag_enum.__name__] = flag_enum
            for member in flag_enum:
                default = flag_default(member)
                cls._defaults[f"{flag_enum.__name__}.{member.name}"] = default
                # Bare name resolves too; a later-registered enum shadows an
                # earlier one (qualified "Enum.MEMBER" names never collide).
                cls._defaults[member.name] = default

    @classmethod
    def load_file(cls, path: str) -> None:
        with open(path, "r", encoding="utf-8") as f:
            props = parse_properties(f.read())
        with cls._lock:
            cls._file_props.update(props)

    @classmethod
    def register_args(cls, argv: Iterable[str]) -> Tuple[str, ...]:
        """Consume ``key=value`` CLI args (highest tier); return the rest.

        Mirrors ``Config.register(args)`` in the reference: non ``k=v`` args
        are passed through to the caller untouched.
        """
        rest = []
        with cls._lock:
            for arg in argv:
                if "=" in arg and not arg.startswith("-"):
                    key, _, val = arg.partition("=")
                    cls._cli[key.strip()] = val.strip()
                else:
                    rest.append(arg)
        return tuple(rest)

    @classmethod
    def set(cls, key: Any, value: Any) -> None:
        """Programmatic override (same tier as CLI)."""
        with cls._lock:
            cls._cli[cls._key_name(key)] = str(value)

    # ---- lookup -------------------------------------------------------
    @staticmethod
    def _key_name(key: Any) -> str:
        if isinstance(key, enum.Enum):
            return key.name
        return str(key)

    @classmethod
    def _lookup_raw(cls, key: Any) -> Tuple[Optional[str], Any]:
        """Return (raw_override_or_None, default)."""
        if isinstance(key, enum.Enum):
            names = (f"{type(key).__name__}.{key.name}", key.name)
            default = flag_default(key)
        else:
            names = (str(key),)
            default = cls._defaults.get(str(key))
        with cls._lock:
            for name in names:
                if name in cls._cli:
                    return cls._cli[name], default
            env = os.environ.get("GP_" + names[-1])
            if env is not None:
                return env, default
            for name in names:
                if name in cls._file_props:
                    return cls._file_props[name], default
        return None, default

    @classmethod
    def get(cls, key: Any) -> Any:
        raw, default = cls._lookup_raw(key)
        if raw is None:
            return default
        return _coerce(raw, default)

    @classmethod
    def is_set(cls, key: Any) -> bool:
        """True when a file/env/CLI tier explicitly provides the key
        (some behaviors — e.g. CLI-node durability — should only switch
        on for an operator's explicit choice, not an enum default)."""
        raw, _ = cls._lookup_raw(key)
        return raw is not None

    # Typed conveniences mirroring the reference's getGlobal{Int,Boolean,...}
    @classmethod
    def get_int(cls, key: Any) -> int:
        return int(cls.get(key))

    @classmethod
    def get_bool(cls, key: Any) -> bool:
        val = cls.get(key)
        if isinstance(val, bool):
            return val
        return str(val).strip().lower() in _TRUE

    @classmethod
    def get_float(cls, key: Any) -> float:
        return float(cls.get(key))

    @classmethod
    def get_str(cls, key: Any) -> str:
        return str(cls.get(key))

    # ---- node address book (active.NAME= / reconfigurator.NAME=) -----
    @classmethod
    def node_addresses(cls, prefix: str) -> Dict[str, Tuple[str, int]]:
        """Extract ``{prefix}.NAME=host:port`` entries from all tiers."""
        out: Dict[str, Tuple[str, int]] = {}
        with cls._lock:
            merged = dict(cls._file_props)
            merged.update(cls._cli)
        want = prefix + "."
        for key, val in merged.items():
            if key.startswith(want):
                name = key[len(want):]
                host, _, port = val.partition(":")
                out[name] = (host, int(port))
        return out

    @classmethod
    def overrides(cls) -> Dict[str, str]:
        """The merged file + programmatic/CLI override tiers, as raw
        strings — what a parent must ship to a spawned worker process
        (as ``key=value`` argv) for the child to see the same effective
        config without sharing a properties file."""
        with cls._lock:
            merged = dict(cls._file_props)
            merged.update(cls._cli)
        return merged

    @classmethod
    def clear(cls) -> None:
        """Reset all overrides (for tests)."""
        with cls._lock:
            cls._file_props.clear()
            cls._cli.clear()


def load_default_config_file() -> None:
    """Load the properties file named by GIGAPAXOS_CONFIG if present."""
    path = os.environ.get("GIGAPAXOS_CONFIG", "gigapaxos.properties")
    if os.path.exists(path):
        Config.load_file(path)
