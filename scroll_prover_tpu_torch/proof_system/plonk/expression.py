"""Gate expression AST.

Expressions are built over column queries with rotations plus constants and
challenges, combined with +, -, *, scaling. Two consumers:
  * mock.py / prover.py evaluate them over full column tables (host ints or
    device limb arrays);
  * verifier.py evaluates them at a point from queried evals.

Mirrors halo2's Expression enum as consumed by the reference's circuits
(SURVEY.md L1, section 2.4 "quotient (expression tree, DistributePowers/
Product/Sum over polynomial refs)").
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ...fields.bn254 import FR_MOD


class Expression:
    def __add__(self, other):
        return Sum(self, _wrap(other))

    __radd__ = __add__

    def __sub__(self, other):
        return Sum(self, Negated(_wrap(other)))

    def __rsub__(self, other):
        return Sum(_wrap(other), Negated(self))

    def __mul__(self, other):
        return Product(self, _wrap(other))

    __rmul__ = __mul__

    def __neg__(self):
        return Negated(self)

    # -- analysis ---------------------------------------------------------
    def degree(self) -> int:
        raise NotImplementedError

    def queries(self) -> set:
        """Set of (kind, col, rot) column queries in this expression."""
        out = set()
        self._collect(out)
        return out

    def _collect(self, out: set):
        raise NotImplementedError

    def evaluate(
        self,
        constant: Callable[[int], Any],
        query: Callable[[str, int, int], Any],
        challenge: Callable[[int], Any],
        add: Callable[[Any, Any], Any],
        mul: Callable[[Any, Any], Any],
        neg: Callable[[Any], Any],
    ) -> Any:
        """Fold the tree with caller-supplied semantics (host or device)."""
        raise NotImplementedError


def _wrap(v) -> Expression:
    if isinstance(v, Expression):
        return v
    return Constant(int(v) % FR_MOD)


@dataclass(frozen=True)
class Constant(Expression):
    value: int

    def degree(self):
        return 0

    def _collect(self, out):
        pass

    def evaluate(self, constant, query, challenge, add, mul, neg):
        return constant(self.value)


@dataclass(frozen=True)
class _Query(Expression):
    col: int
    rot: int = 0

    KIND = "?"

    def degree(self):
        return 1

    def _collect(self, out):
        out.add((self.KIND, self.col, self.rot))

    def evaluate(self, constant, query, challenge, add, mul, neg):
        return query(self.KIND, self.col, self.rot)


class Fixed(_Query):
    KIND = "fixed"


class Advice(_Query):
    KIND = "advice"


class Instance(_Query):
    KIND = "instance"


@dataclass(frozen=True)
class Challenge(Expression):
    index: int

    def degree(self):
        return 0

    def _collect(self, out):
        pass

    def evaluate(self, constant, query, challenge, add, mul, neg):
        return challenge(self.index)


@dataclass(frozen=True)
class Sum(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return max(self.a.degree(), self.b.degree())

    def _collect(self, out):
        self.a._collect(out)
        self.b._collect(out)

    def evaluate(self, constant, query, challenge, add, mul, neg):
        return add(
            self.a.evaluate(constant, query, challenge, add, mul, neg),
            self.b.evaluate(constant, query, challenge, add, mul, neg),
        )


@dataclass(frozen=True)
class Product(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return self.a.degree() + self.b.degree()

    def _collect(self, out):
        self.a._collect(out)
        self.b._collect(out)

    def evaluate(self, constant, query, challenge, add, mul, neg):
        return mul(
            self.a.evaluate(constant, query, challenge, add, mul, neg),
            self.b.evaluate(constant, query, challenge, add, mul, neg),
        )


@dataclass(frozen=True)
class Negated(Expression):
    a: Expression

    def degree(self):
        return self.a.degree()

    def _collect(self, out):
        self.a._collect(out)

    def evaluate(self, constant, query, challenge, add, mul, neg):
        return neg(self.a.evaluate(constant, query, challenge, add, mul, neg))
