"""Fluent chaining API with runtime-checked invertibility, on PyTorch.

Counterpart of ``pragma_dsp_tpu/fluent/chain.py``. Parity with reference
src/fluent/complex.ts:37-332. The reference encodes a
typestate ``{kind, hasFft, invert, len}`` in TypeScript generics so that
``.inverse()`` is *compile-time* gated. Python has no typestate, so —
exactly as SURVEY.md §7 prescribes — the ``inverseChecked`` semantics
(complex.ts:304-320) become the runtime contract here: the same state tuple
is tracked as runtime tags, ``.inverse()`` raises ``NotInvertibleError``
when the chain's state no longer guarantees a faithful round-trip, and
``.inverse_checked()`` returns an explicit result union.

One deliberate departure, kept from the JAX package: chainable ops return
a NEW chain instead of mutating in place (the reference mutates and returns
``this``). ``.clone()`` copies the planes, since tensors are mutable.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch

from ..core.complex import ComplexArray, as_complex_array
from ..math import complex_ops as cmath

__all__ = [
    "NonZero",
    "assert_non_zero",
    "as_non_zero",
    "ChainState",
    "InverseError",
    "NotInvertibleError",
    "InverseResult",
    "ComplexChain",
    "chain",
]


class NonZero(float):
    """Branded nonzero scalar (reference complex.ts:77-96).

    The reference brands ``number`` at the type level; here the brand is a
    float subclass produced only by the checked constructors below, and ops
    that receive a ``NonZero`` preserve invertibility ("yes") while a plain
    float downgrades it to "maybe" — mirroring the typestate overloads
    (complex.ts:165-174).
    """

    def __new__(cls, x: float):
        if x == 0:
            raise ValueError("Expected nonzero value, got 0")
        return super().__new__(cls, x)


def assert_non_zero(x: float) -> NonZero:
    """Throws on 0, narrows otherwise (reference assertNonZero)."""
    return NonZero(x)


def as_non_zero(x: float) -> Optional[NonZero]:
    """Returns NonZero or None (reference asNonZero)."""
    return NonZero(x) if x != 0 else None


@dataclass(frozen=True)
class ChainState:
    """Runtime replica of the reference's type-level ChainState
    (complex.ts:37-42)."""

    kind: str = "complex"      # "complex" | "real"
    has_fft: bool = False
    invert: str = "yes"        # "yes" | "no" | "maybe"
    length: str = "same"       # "same" | "changed"


DEFAULT_STATE = ChainState()
FFT_FORWARD_STATE = ChainState(has_fft=True)


@dataclass(frozen=True)
class InverseError:
    """Tagged error union (reference complex.ts:100-104)."""

    tag: str                   # "NoFftContext" | "NotInvertible" | "LengthMismatch"
    reason: str = ""


class NotInvertibleError(RuntimeError):
    def __init__(self, error: InverseError):
        super().__init__(f"{error.tag}: {error.reason}")
        self.error = error


@dataclass(frozen=True)
class InverseResult:
    """Explicit {ok, value|error} union (reference complex.ts:106-108)."""

    ok: bool
    value: Optional[ComplexArray] = None
    error: Optional[InverseError] = None


InverseFn = Callable[[ComplexArray], ComplexArray]


class ComplexChain:
    """Fluent wrapper over a ComplexArray (reference complex.ts:123-332).

    Functional: each op returns a new chain carrying updated data + state.
    """

    def __init__(self, data: ComplexArray, inverse_fn: Optional[InverseFn] = None,
                 state: ChainState = DEFAULT_STATE):
        self.data = as_complex_array(data)
        self._inverse_fn = inverse_fn
        self.state = state

    # ── identity / accessors ─────────────────────────────────────────

    def unwrap(self) -> ComplexArray:
        """The underlying {real, imag} (reference complex.ts:141-143)."""
        return self.data

    def __len__(self) -> int:
        return self.data.real.shape[-1]

    @property
    def length(self) -> int:
        return len(self)

    def clone(self) -> "ComplexChain":
        """Independent copy preserving state (reference complex.ts:152-155)."""
        return ComplexChain(cmath.copy(self.data), self._inverse_fn, self.state)

    # ── chainable ops ────────────────────────────────────────────────

    def _next(self, data: ComplexArray, invert: Optional[str] = None) -> "ComplexChain":
        state = self.state if invert is None else replace(self.state, invert=invert)
        return ComplexChain(data, self._inverse_fn, state)

    def _degrade(self, current: str) -> str:
        # "no" is sticky; otherwise known-destructive ops give "maybe".
        return "no" if current == "no" else "maybe"

    def scale(self, s) -> "ComplexChain":
        """Real-scalar multiply. NonZero preserves invertibility, a plain
        number downgrades it to "maybe" (reference complex.ts:165-174)."""
        invert = None if isinstance(s, NonZero) else self._degrade(self.state.invert)
        return self._next(cmath.scale(self.data, float(s)), invert)

    def mul(self, b) -> "ComplexChain":
        """Hadamard multiply -> invert becomes "maybe" (complex.ts:180-187)."""
        return self._next(cmath.mul(self.data, as_complex_array(b)),
                          self._degrade(self.state.invert))

    def mul_scalar(self, re, im) -> "ComplexChain":
        """Complex-scalar multiply; invertibility preserved iff either part
        is NonZero (reference overloads, complex.ts:189-205)."""
        nz = isinstance(re, NonZero) or isinstance(im, NonZero)
        invert = None if nz else self._degrade(self.state.invert)
        return self._next(cmath.mul_scalar(self.data, float(re), float(im)), invert)

    def div(self, b) -> "ComplexChain":
        """Element-wise complex division -> "maybe" (complex.ts:210-217)."""
        return self._next(cmath.div(self.data, as_complex_array(b)),
                          self._degrade(self.state.invert))

    def div_scalar(self, re, im) -> "ComplexChain":
        """Complex-scalar divide; NonZero in either slot preserves state
        (reference complex.ts:221-237)."""
        nz = isinstance(re, NonZero) or isinstance(im, NonZero)
        invert = None if nz else self._degrade(self.state.invert)
        return self._next(cmath.div_scalar(self.data, float(re), float(im)), invert)

    def conj(self) -> "ComplexChain":
        """Self-inverse — preserves invertibility (complex.ts:239-242)."""
        return self._next(cmath.conj(self.data))

    def add(self, b) -> "ComplexChain":
        """Element-wise add -> "maybe" (complex.ts:245-250)."""
        return self._next(cmath.add(self.data, as_complex_array(b)),
                          self._degrade(self.state.invert))

    def sub(self, b) -> "ComplexChain":
        """Element-wise subtract -> "maybe" (complex.ts:253-258)."""
        return self._next(cmath.sub(self.data, as_complex_array(b)),
                          self._degrade(self.state.invert))

    # ── terminal projections ─────────────────────────────────────────

    def mag(self) -> torch.Tensor:
        """Magnitude projection — terminal (complex.ts:267-269)."""
        return cmath.mag(self.data)

    def arg(self) -> torch.Tensor:
        """Phase projection — terminal (complex.ts:275-277)."""
        return cmath.arg(self.data)

    # ── inverse ──────────────────────────────────────────────────────

    def _inverse_error(self) -> Optional[InverseError]:
        if self._inverse_fn is None or not self.state.has_fft:
            return InverseError("NoFftContext",
                                "chain was not created by FluentFFT.forward()")
        if self.state.kind != "complex":
            return InverseError("NotInvertible", "complex info was projected away")
        if self.state.length != "same":
            return InverseError("LengthMismatch", "chain length changed")
        if self.state.invert != "yes":
            return InverseError(
                "NotInvertible",
                f'invertibility is "{self.state.invert}" after a potentially '
                "destructive op; use inverse_checked() or NonZero scalars",
            )
        return None

    def inverse(self) -> ComplexArray:
        """Apply the bound inverse FFT (reference complex.ts:293-298).

        The reference gates this at compile time via the InverseReady
        typestate; here the same predicate is enforced at runtime and
        violation raises NotInvertibleError.
        """
        err = self._inverse_error()
        if err is not None:
            raise NotInvertibleError(err)
        return self._inverse_fn(self.data)

    def inverse_checked(self) -> InverseResult:
        """Runtime-safe inverse returning {ok, value|error}
        (reference complex.ts:304-320). Callable whenever has_fft is true,
        regardless of the invert tag."""
        if self._inverse_fn is None or not self.state.has_fft:
            return InverseResult(ok=False, error=InverseError(
                "NoFftContext", "chain was not created by FluentFFT.forward()"))
        try:
            return InverseResult(ok=True, value=self._inverse_fn(self.data))
        except Exception as e:  # mirror the reference's try/catch wrapping
            return InverseResult(ok=False, error=InverseError(
                "NotInvertible", str(e)))


def chain(data) -> ComplexChain:
    """Wrap raw complex data without FFT context (reference complex.ts:326-332)."""
    return ComplexChain(as_complex_array(data), None, DEFAULT_STATE)
