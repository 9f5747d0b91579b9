"""Per-layer ADC register state: the artifact Algorithm 1 produces.

Port of ``repro.core.quant_state``.  ``QuantState`` maps layer names
(param-path-style strings such as ``layer_0/attn/wq``) to
:class:`~repro_torch.core.trq.TRQParams` through an ordered regex rule table
(first match wins).  A ``Runtime`` owns its state and passes it
explicitly; ``use_quant_state`` installs an ambient one, which
``runtime.compile`` and a ``PimContext`` built without a ``quant_state``
take, as the reference's.  The JSON format is the
reference's, versioned (``"version": 1``), so a file written by
``repro.core.quant_state.save_quant_state`` loads here unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
from typing import Any, Mapping, Optional

from .trq import TRQParams, make_params

QUANT_STATE_FILE = "quant_state.json"
QUANT_STATE_VERSION = 1

_STATIC_FIELDS = ("n_r1", "n_r2", "m", "nu", "mode", "signed")


@dataclasses.dataclass(frozen=True)
class QuantState:
    """Ordered (pattern, TRQParams) rules + optional default."""

    rules: tuple = ()                       # ((pattern, TRQParams), ...)
    default: Optional[TRQParams] = None

    def lookup(self, name: Optional[str]) -> Optional[TRQParams]:
        if name is not None:
            for pat, params in self.rules:
                if re.search(pat, name):
                    return params
        return self.default

    def __len__(self) -> int:
        return len(self.rules)


# ---------------------------------------------------------------------------
# ambient state (mirrors dist.sharding.use_mesh)
# ---------------------------------------------------------------------------

_ACTIVE: dict = {"qs": None}


@contextlib.contextmanager
def use_quant_state(qs: Optional[QuantState]):
    """Install ``qs`` as the active per-layer register file in the dynamic
    extent.  ``None`` is a no-op (keeps call sites unconditional).
    Nestable; restores the outer state."""
    prev = _ACTIVE["qs"]
    if qs is not None:
        _ACTIVE["qs"] = qs
    try:
        yield qs
    finally:
        _ACTIVE["qs"] = prev


def active_quant_state() -> Optional[QuantState]:
    return _ACTIVE["qs"]


def quant_state_from_calibration(cal: Mapping[str, Any], *,
                                 signed: Optional[bool] = None,
                                 default: Optional[TRQParams] = None,
                                 exact_names: bool = True) -> QuantState:
    """{layer name: LayerCalibration | TRQParams} -> QuantState.

    ``signed`` overrides the signed flag on every rule (the LM fast path
    quantizes signed per-group partial sums; Algorithm 1 calibrates on the
    unsigned bit-line grid).  ``exact_names`` anchors each name as a
    full-string regex; pass False when the keys already are patterns."""
    rules = []
    for name, c in cal.items():
        p = c.params if hasattr(c, "params") else c
        if signed is not None and p.signed != signed:
            p = p.replace(signed=signed)
        pat = f"^{re.escape(name)}$" if exact_names else name
        rules.append((pat, p))
    return QuantState(rules=tuple(rules), default=default)


def _params_to_dict(p: TRQParams) -> dict:
    d = {"delta_r1": float(p.delta_r1), "bias": float(p.bias)}
    d.update({f: getattr(p, f) for f in _STATIC_FIELDS})
    return d


def _params_from_dict(d: dict) -> TRQParams:
    return make_params(delta_r1=d["delta_r1"], bias=d["bias"],
                       **{f: d[f] for f in _STATIC_FIELDS})


def quant_state_to_dict(qs: QuantState) -> dict:
    return {"version": QUANT_STATE_VERSION,
            "rules": [{"pattern": pat, "params": _params_to_dict(p)}
                      for pat, p in qs.rules],
            "default": (_params_to_dict(qs.default)
                        if qs.default is not None else None)}


def quant_state_from_dict(d: dict) -> QuantState:
    # files written before versioning are schema 1; a newer schema must
    # fail loudly (the registers program the ADC — a misparse is silent)
    version = d.get("version", 1)
    if version != QUANT_STATE_VERSION:
        raise ValueError(
            f"quant_state schema version {version} is not supported "
            f"(expected {QUANT_STATE_VERSION}); load it with the version "
            f"that wrote it or re-calibrate")
    rules = tuple((r["pattern"], _params_from_dict(r["params"]))
                  for r in d.get("rules", ()))
    default = d.get("default")
    return QuantState(rules=rules,
                      default=_params_from_dict(default) if default else None)


def _resolve_path(path: str) -> str:
    """A directory (e.g. a checkpoint dir) means <dir>/quant_state.json."""
    return path if path.endswith(".json") else \
        os.path.join(path, QUANT_STATE_FILE)


def save_quant_state(path: str, qs: QuantState) -> str:
    """Write ``qs`` as JSON (atomic rename); returns the written path."""
    path = _resolve_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(quant_state_to_dict(qs), f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_quant_state(path: str) -> QuantState:
    """Read a register file; a corrupt file raises ``ValueError``."""
    resolved = _resolve_path(path)
    with open(resolved) as f:
        try:
            payload = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"quant state file {resolved!r} is not valid JSON "
                f"({e.msg} at line {e.lineno}); the file is truncated or "
                f"corrupt — recalibrate or restore it from the "
                f"checkpoint") from e
    return quant_state_from_dict(payload)
