"""Torch evaluation of the deck's function-valued parameters.

Deck parsing itself is shared with the JAX package (``hipace_tpu.parser``,
which imports only numpy). Its function compiler evaluates with jax.numpy,
so the port evaluates the same translated expressions against a torch math
namespace instead. Python-number arguments of the math functions are lifted
to tensors of the caller's dtype and device.
"""

from __future__ import annotations

import torch

from hipace_tpu.parser import _PREDEFINED_SI, Inputs, _translate_expr

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
        out = eval(self.expr, {"__builtins__": {}}, ns)  # noqa: S307
        out = torch.as_tensor(out, dtype=ref.dtype, device=ref.device)
        return torch.broadcast_to(out, ref.shape)


def deck_function(inputs: Inputs, keys, argnames,
                  default: str | None = None) -> TorchFunction | None:
    """The first of `keys` given as a function parameter in the deck (e.g.
    ``plasma.density(x,y,z) = ...``), or `default`, or None."""
    for key in keys:
        if key in inputs._funcs:
            args, expr = inputs._funcs[key]
            return TorchFunction(expr, args, inputs.my_constants)
    if default is None:
        return None
    return TorchFunction(default, argnames, inputs.my_constants)
