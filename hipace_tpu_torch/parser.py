"""Inputs-file parser compatible with the HiPACE++/AMReX ParmParse format.

The port's own copy of the deck parser of ``hipace_tpu/parser.py:31-381``
(``Inputs``, ``PrefixView``, ``_translate_expr``, ``_PREDEFINED_SI``), which
reads the same `key = value` decks as the reference:

- ``prefix.key = v1 v2 v3`` multi-value entries
- ``#`` comments
- ``my_constants.<name> = <expression>`` user constants
- math expressions in any numeric field, with the predefined physics
  constants pi, clight, epsilon0, mu0, q_e, m_e, m_p, hbar
- function-valued parameters such as ``plasma.density(x,y,z) = ...``
- command-line style overrides ``key=value``

Scalar expressions are evaluated with numpy. Where the JAX package compiles
function-valued parameters to jax.numpy callables (``get_function``,
``compile_function``), the port evaluates the same translated expressions
against a torch math namespace: ``TorchFunction``. Python-number arguments
of the math functions are lifted to tensors of the caller's dtype and
device.
"""

from __future__ import annotations

import re
from typing import Any, Sequence

import numpy as np
import torch

from . import constants

_PREDEFINED_SI = {
    "pi": constants.PI,
    "clight": constants.SI_c,
    "epsilon0": constants.SI_ep0,
    "mu0": constants.SI_mu0,
    "q_e": constants.SI_q_e,
    "m_e": constants.SI_m_e,
    "m_p": constants.SI_m_p,
    "hbar": constants.SI_hbar,
    "r_e": constants.SI_r_e,
    "inf": float("inf"),
    "infinity": float("inf"),
    "true": 1,
    "false": 0,
}


# math functions of scalar expressions
_MATH_NAMESPACE = {
    "sqrt": np.sqrt, "exp": np.exp, "log": np.log, "log10": np.log10,
    "sin": np.sin, "cos": np.cos, "tan": np.tan, "asin": np.arcsin,
    "acos": np.arccos, "atan": np.arctan, "atan2": np.arctan2,
    "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh, "abs": np.abs,
    "fabs": np.abs, "floor": np.floor, "ceil": np.ceil, "fmod": np.fmod,
    "pow": np.power, "min": np.minimum, "max": np.maximum,
    "heaviside": np.heaviside,
    "where": np.where,  # also the target of if(cond, a, b)
}


_IF_RE = re.compile(r"\bif\s*\(")


def _translate_expr(expr: str) -> str:
    """AMReX parser syntax -> python: ^ -> **, &&/|| -> and/or, and the
    keyword-colliding if(cond, a, b) -> where(cond, a, b)."""
    expr = expr.replace("^", "**").replace("&&", " and ").replace("||", " or ")
    return _IF_RE.sub("where(", expr)


_FUNC_KEY_RE = re.compile(r"^([\w.]+)\(([\w,\s]*)\)$")


class Inputs:
    """Parsed inputs deck with ParmParse-style typed queries."""

    def __init__(self, text: str = "", overrides: Sequence[str] = ()):
        # raw entries: full key -> raw value string
        self._raw: dict[str, str] = {}
        # function entries: base key -> (argnames, expression)
        self._funcs: dict[str, tuple[tuple[str, ...], str]] = {}
        # every key the code has asked for (present in the deck or not):
        # the runtime parameter surface. Function-valued parameters are
        # recorded with a "()" suffix.
        self._queried: set[str] = set()
        if text:
            self._parse_text(text)
        for ov in overrides:
            self._parse_line(ov)
        self.my_constants = self._build_constants()

    @classmethod
    def from_file(cls, path: str, overrides: Sequence[str] = ()) -> "Inputs":
        with open(path) as f:
            return cls(f.read(), overrides)

    def override(self, key: str, value) -> None:
        """Set/replace one parameter after parsing (CLI-override semantics,
        ref: tests/*.sh pass key=value args past the inputs file)."""
        self._parse_line(f"{key} = {value}")
        if key.startswith("my_constants."):
            self.my_constants = self._build_constants()

    # ------------------------------------------------------------------
    def _parse_text(self, text: str) -> None:
        # support line continuation with '\'
        text = text.replace("\\\n", " ")
        # multi-line quoted values (AMReX ParmParse style): a line whose
        # value opens a double quote continues until the closing quote
        lines = text.splitlines()
        merged: list[str] = []
        buf = ""
        for line in lines:
            if buf:
                buf += " " + line
                if line.count('"') % 2 == 1:
                    merged.append(buf)
                    buf = ""
                continue
            stripped = line.split("#", 1)[0]
            if "=" in stripped:
                val = stripped.split("=", 1)[1]
                if val.count('"') % 2 == 1:
                    buf = line
                    continue
            merged.append(line)
        if buf:
            merged.append(buf)
        for line in merged:
            self._parse_line(line)

    def _parse_line(self, line: str) -> None:
        line = line.split("#", 1)[0].strip()
        if not line:
            return
        if "=" not in line:
            return
        key, val = line.split("=", 1)
        key = key.strip()
        # AMReX ParmParse quotes keys containing parentheses, e.g.
        # "elec.density(x,y,z)" = ne (ref inputs_ion_motion_SI:44)
        if key.startswith('"') and key.endswith('"') and len(key) > 1:
            key = key[1:-1].strip()
        val = val.strip()
        # strip outer quotes only when the whole value is one quoted string;
        # multi-token values like '"expr1" "expr2" -1.' keep their interior
        # quotes for _split (ref parameters.rst:35-36)
        if val.startswith('"') and val.endswith('"') and val.count('"') == 2:
            val = val[1:-1]
        m = _FUNC_KEY_RE.match(key)
        if m:
            base = m.group(1)
            args = tuple(a.strip() for a in m.group(2).split(",") if a.strip())
            self._funcs[base] = (args, val)
            self._raw[key] = val
        else:
            self._raw[key] = val

    def _build_constants(self) -> dict[str, float]:
        consts = dict(_PREDEFINED_SI)
        pending = {
            k[len("my_constants."):]: v
            for k, v in self._raw.items() if k.startswith("my_constants.")
        }
        # iterate to resolve constants that reference each other
        for _ in range(len(pending) + 1):
            progressed = False
            for name, expr in list(pending.items()):
                try:
                    consts[name] = self._eval(expr, consts)
                    del pending[name]
                    progressed = True
                except Exception:
                    pass
            if not pending or not progressed:
                break
        if pending:
            raise ValueError(f"Could not resolve my_constants: {list(pending)}")
        return consts

    # ------------------------------------------------------------------
    @staticmethod
    def _eval(expr: str, env: dict[str, Any]):
        expr = _translate_expr(expr)
        ns = dict(env)
        ns.update(_MATH_NAMESPACE)
        return eval(expr, {"__builtins__": {}}, ns)  # noqa: S307 - restricted

    def _eval_scalar(self, expr: str):
        v = self._eval(expr, self.my_constants)
        return v

    # ------------------------------------------------------------------
    def contains(self, key: str) -> bool:
        return key in self._raw or key in self._funcs

    def raw(self, key: str, default: str | None = None) -> str | None:
        self._queried.add(key)
        if key in self._raw:
            return self._raw[key]
        return default

    def get(self, key: str, dtype=float):
        """Get a single typed value; raises if missing."""
        self._queried.add(key)
        if key not in self._raw:
            raise KeyError(f"Missing required input: {key}")
        return self._convert(self._raw[key], dtype)

    def query(self, key: str, default, dtype=None):
        """Get a single typed value with default."""
        self._queried.add(key)
        if key not in self._raw:
            return default
        if dtype is None:
            dtype = type(default)
        return self._convert(self._raw[key], dtype)

    def get_list(self, key: str, dtype=float) -> list:
        self._queried.add(key)
        if key not in self._raw:
            raise KeyError(f"Missing required input: {key}")
        return [self._convert(tok, dtype) for tok in self._split(self._raw[key])]

    def query_list(self, key: str, default: list, dtype=None) -> list:
        self._queried.add(key)
        if key not in self._raw:
            return list(default)
        if dtype is None:
            dtype = type(default[0]) if default else float
        return [self._convert(tok, dtype) for tok in self._split(self._raw[key])]

    def _split(self, val: str) -> list[str]:
        # values may contain expressions with spaces inside parentheses or
        # double quotes (ref parameters.rst:35-36): split on whitespace at
        # paren depth 0 outside quotes; quotes are stripped from the token
        toks, depth, cur, in_q = [], 0, [], False
        for ch in val:
            if ch == '"':
                in_q = not in_q
                continue
            if not in_q:
                if ch in "([":
                    depth += 1
                elif ch in ")]":
                    depth -= 1
                if ch.isspace() and depth == 0:
                    if cur:
                        toks.append("".join(cur))
                        cur = []
                    continue
            cur.append(ch)
        if cur:
            toks.append("".join(cur))
        return toks

    def _convert(self, tok: str, dtype):
        if dtype is str:
            # {...} interpolation in string parameters: paste my_constants
            # or evaluate the braced expression (ref parameters.rst:37-38)
            if "{" in tok:
                def _sub(m):
                    expr = m.group(1)
                    if expr in self.my_constants:
                        v = self.my_constants[expr]
                    else:
                        v = self._eval_scalar(expr)
                    if isinstance(v, float) and v == int(v):
                        return str(int(v))
                    return str(v)

                tok = re.sub(r"\{([^{}]+)\}", _sub, tok)
            return tok
        if dtype is bool:
            v = self._eval_scalar(tok)
            return bool(v)
        v = self._eval_scalar(tok)
        if dtype is int:
            iv = int(round(float(v)))
            return iv
        return dtype(v)

    # ------------------------------------------------------------------
    def get_function(self, key: str, argnames: Sequence[str],
                     default: str | None = None) -> "TorchFunction | None":
        """A function-valued parameter as a callable on tensors.

        e.g. get_function("plasma.density", ("x","y","z")) for an inputs entry
        ``plasma.density(x,y,z) = 1.1*exp(-(x**2+y**2)/2)``.
        Returns None if absent and no default given.
        """
        self._queried.add(key + "()")
        if key in self._funcs:
            args, expr = self._funcs[key]
        elif default is not None:
            args, expr = tuple(argnames), default
        else:
            return None
        return TorchFunction(expr, args, self.my_constants)

    # ------------------------------------------------------------------
    def prefix(self, pre: str) -> "PrefixView":
        return PrefixView(self, pre)


class PrefixView:
    """View of an Inputs with a fixed key prefix, like amrex::ParmParse(pre)."""

    def __init__(self, inputs: Inputs, pre: str):
        self._inputs = inputs
        self._pre = pre + "." if pre else ""

    def _k(self, key: str) -> str:
        return self._pre + key

    def contains(self, key):
        return self._inputs.contains(self._k(key))

    def get(self, key, dtype=float):
        return self._inputs.get(self._k(key), dtype)

    def query(self, key, default, dtype=None):
        return self._inputs.query(self._k(key), default, dtype)

    def get_list(self, key, dtype=float):
        return self._inputs.get_list(self._k(key), dtype)

    def query_list(self, key, default, dtype=None):
        return self._inputs.query_list(self._k(key), default, dtype)

    def get_function(self, key, argnames, default=None):
        return self._inputs.get_function(self._k(key), argnames, default)


_TORCH_MATH = {
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "log10": torch.log10, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
    "atan": torch.atan, "atan2": torch.atan2,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "abs": torch.abs, "fabs": torch.abs, "floor": torch.floor,
    "ceil": torch.ceil, "fmod": torch.fmod, "pow": torch.pow,
    "min": torch.minimum, "max": torch.maximum,
    "heaviside": torch.heaviside,
    "where": torch.where,  # also the target of if(cond, a, b)
}


def _namespace(dtype, device) -> dict:
    def lift(fn):
        def call(*args):
            return fn(*[a if isinstance(a, torch.Tensor)
                        else torch.tensor(a, dtype=dtype, device=device)
                        for a in args])
        return call
    return {name: lift(fn) for name, fn in _TORCH_MATH.items()}


class TorchFunction:
    """A deck expression of named arguments, evaluated on tensors.

    The result is broadcast to the shape of the first argument and cast to
    its dtype, so constant expressions ("1.") give full arrays."""

    def __init__(self, expr: str, argnames, consts: dict):
        self.expr = _translate_expr(expr)
        self.argnames = tuple(argnames)
        self.consts = dict(_PREDEFINED_SI)
        self.consts.update(consts)

    def __call__(self, *vals: torch.Tensor) -> torch.Tensor:
        ref = vals[0]
        ns = dict(self.consts)
        ns.update(_namespace(ref.dtype, ref.device))
        ns.update(zip(self.argnames, vals))
        # torch imports submodules lazily on an operator's first call, so
        # __import__ must be reachable; the namespace is otherwise restricted
        out = eval(self.expr,  # noqa: S307
                   {"__builtins__": {"__import__": __import__}}, ns)
        if not torch.is_tensor(out):
            # a constant: filled on the device, with no copy from the host
            return torch.full_like(ref, out)
        out = torch.as_tensor(out, dtype=ref.dtype, device=ref.device)
        return torch.broadcast_to(out, ref.shape)


def deck_function(inputs: Inputs, keys, argnames,
                  default: str | None = None) -> TorchFunction | None:
    """The first of `keys` given as a function parameter in the deck (e.g.
    ``plasma.density(x,y,z) = ...``), or `default`, or None."""
    for key in keys:
        fn = inputs.get_function(key, argnames)
        if fn is not None:
            return fn
    if default is None:
        return None
    return TorchFunction(default, argnames, inputs.my_constants)
