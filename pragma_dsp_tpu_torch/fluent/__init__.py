"""Opt-in fluent chaining rung (reference src/fluent/index.ts:1-14)."""

from .chain import (
    ChainState,
    ComplexChain,
    InverseError,
    InverseResult,
    NonZero,
    NotInvertibleError,
    as_non_zero,
    assert_non_zero,
    chain,
)

__all__ = [
    "ChainState",
    "ComplexChain",
    "InverseError",
    "InverseResult",
    "NonZero",
    "NotInvertibleError",
    "as_non_zero",
    "assert_non_zero",
    "chain",
]
