"""Rule-based filter DSL (paper §3.3, Eq. 10-19).

Rules are boolean expressions over $-prefixed strategy parameters:

    $use_flash_attn != none && $recompute_granularity = selective
    $recompute_num_layers > $pipeline_model_parallel_size
    $num_gpus % ($pipeline_model_parallel_size * $tensor_model_parallel_size) != 0

Semantics follow the paper exactly: a strategy is VALID iff every rule
evaluates to False (Eq. 10 — rules describe *forbidden* configurations).
``&&`` binds tighter than ``||`` (Eq. 19) and chains evaluate left-to-right.
Comparison uses a single ``=`` for equality, as in the paper's examples.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+(\.\d+)?)
  | (?P<var>\$[A-Za-z_][A-Za-z0-9_\-]*)
  | (?P<op>&&|\|\||!=|>=|<=|=|>|<|\+|-|\*|/|%|\(|\))
  | (?P<ident>[A-Za-z_][A-Za-z0-9_\-]*)
    """,
    re.VERBOSE,
)

_KEYWORDS = {"true": True, "false": False, "none": None}


class RuleSyntaxError(ValueError):
    pass


def tokenize(text: str) -> list[str]:
    tokens, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise RuleSyntaxError(f"bad character at {pos}: {text[pos:pos+10]!r}")
        pos = m.end()
        if m.lastgroup != "ws":
            tokens.append(m.group())
    return tokens


@dataclasses.dataclass
class _Parser:
    """Recursive-descent parser producing a nested-tuple AST."""

    tokens: list[str]
    pos: int = 0

    def peek(self) -> str | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def take(self) -> str:
        tok = self.peek()
        if tok is None:
            raise RuleSyntaxError("unexpected end of rule")
        self.pos += 1
        return tok

    def expect(self, tok: str) -> None:
        got = self.take()
        if got != tok:
            raise RuleSyntaxError(f"expected {tok!r}, got {got!r}")

    # grammar: or -> and (|| and)* ; and -> cmp (&& cmp)* ;
    # cmp -> arith ((=|!=|>|<|>=|<=) arith)? ; arith -> term ((+|-) term)* ;
    # term -> atom ((*|/|%) atom)* ; atom -> num | $var | ident | ( or )
    def parse(self):
        node = self.parse_or()
        if self.peek() is not None:
            raise RuleSyntaxError(f"trailing tokens: {self.tokens[self.pos:]}")
        return node

    def parse_or(self):
        node = self.parse_and()
        while self.peek() == "||":
            self.take()
            node = ("or", node, self.parse_and())
        return node

    def parse_and(self):
        node = self.parse_cmp()
        while self.peek() == "&&":
            self.take()
            node = ("and", node, self.parse_cmp())
        return node

    def parse_cmp(self):
        left = self.parse_arith()
        if self.peek() in ("=", "!=", ">", "<", ">=", "<="):
            op = self.take()
            return ("cmp", op, left, self.parse_arith())
        return left

    def parse_arith(self):
        node = self.parse_term()
        while self.peek() in ("+", "-"):
            op = self.take()
            node = ("arith", op, node, self.parse_term())
        return node

    def parse_term(self):
        node = self.parse_atom()
        while self.peek() in ("*", "/", "%"):
            op = self.take()
            node = ("arith", op, node, self.parse_atom())
        return node

    def parse_atom(self):
        tok = self.take()
        if tok == "(":
            node = self.parse_or()
            self.expect(")")
            return node
        if tok.startswith("$"):
            return ("var", tok[1:])
        if re.fullmatch(r"\d+(\.\d+)?", tok):
            return ("lit", float(tok) if "." in tok else int(tok))
        if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_\-]*", tok):
            key = tok.lower()
            return ("lit", _KEYWORDS[key]) if key in _KEYWORDS else ("lit", tok)
        raise RuleSyntaxError(f"unexpected token {tok!r}")


def _truthy(v: Any) -> bool:
    return bool(v)


def _eval(node, env: Mapping[str, Any]):
    kind = node[0]
    if kind == "lit":
        return node[1]
    if kind == "var":
        name = node[1].replace("-", "_")
        if name not in env:
            raise KeyError(f"unknown strategy parameter ${node[1]}")
        return env[name]
    if kind == "or":
        return _truthy(_eval(node[1], env)) or _truthy(_eval(node[2], env))
    if kind == "and":
        return _truthy(_eval(node[1], env)) and _truthy(_eval(node[2], env))
    if kind == "arith":
        op, a, b = node[1], _eval(node[2], env), _eval(node[3], env)
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        return a % b
    if kind == "cmp":
        op, a, b = node[1], _eval(node[2], env), _eval(node[3], env)
        if op == "=":
            return a == b
        if op == "!=":
            return a != b
        # normalize bools for ordered comparison against numbers
        if op == ">":
            return a > b
        if op == "<":
            return a < b
        if op == ">=":
            return a >= b
        return a <= b
    raise AssertionError(f"bad node {node!r}")


# ---------------------------------------------------------------------------
# block-mask evaluation (vectorized funnel)
# ---------------------------------------------------------------------------
#
# ``_eval_block`` mirrors ``_eval`` over whole candidate blocks: env values
# are numpy columns (one entry per candidate), CategoricalColumn for
# non-numeric parameters, or plain Python scalars for block-constant values
# (scalar subexpressions then fold through ``_eval``-identical Python
# arithmetic for free). Any construct whose vectorization could diverge from
# the per-candidate interpreter — non-numeric arithmetic, ordered comparison
# of mixed types, a zero divisor anywhere in a block (Python raises, numpy
# warns-and-continues), a missing variable — raises :class:`MaskCompileError`
# instead of guessing, and the caller re-runs that rule through the scalar
# interpreter. The mask path therefore either returns provably identical
# verdicts or defers; it never silently disagrees.


class MaskCompileError(Exception):
    """A rule (or subexpression) has no faithful block-mask evaluation."""


class CategoricalColumn:
    """A non-numeric strategy column: small unique-value table + int codes.

    Comparisons against a literal evaluate once per unique value (plain
    Python semantics), then broadcast through the code array — so string
    parameters cost one gather per rule instead of one compare per candidate.
    """

    __slots__ = ("values", "codes")

    def __init__(self, values: Sequence[Any], codes: np.ndarray):
        self.values = tuple(values)
        self.codes = np.asarray(codes, dtype=np.int64)

    def lut(self, fn: "Callable[[Any], bool]") -> np.ndarray:
        table = np.fromiter((bool(fn(v)) for v in self.values), bool,
                            len(self.values))
        return table.take(self.codes)


_NUMERIC_KINDS = "biuf"


def _is_numeric_array(v: Any) -> bool:
    return isinstance(v, np.ndarray) and v.dtype.kind in _NUMERIC_KINDS


def _is_plain_scalar(v: Any) -> bool:
    return not isinstance(v, (np.ndarray, CategoricalColumn))


def _truthy_block(v: Any):
    """Vectorized ``_truthy``: bool array per candidate, or a Python bool."""
    if isinstance(v, CategoricalColumn):
        return v.lut(bool)
    if isinstance(v, np.ndarray):
        if v.dtype.kind == "b":
            return v
        if v.dtype.kind in _NUMERIC_KINDS:
            return v != 0
        raise MaskCompileError(f"no truthiness for dtype {v.dtype}")
    return bool(v)


def _as_arith_operand(v: Any):
    """Coerce for arithmetic: bool arrays widen to int64 so ``true + true``
    is 2 (Python semantics), not numpy's saturating boolean add."""
    if isinstance(v, CategoricalColumn):
        raise MaskCompileError("arithmetic on a non-numeric column")
    if isinstance(v, np.ndarray):
        if v.dtype.kind == "b":
            return v.astype(np.int64)
        if v.dtype.kind not in _NUMERIC_KINDS:
            raise MaskCompileError(f"arithmetic on dtype {v.dtype}")
        return v
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return v
    raise MaskCompileError(f"arithmetic on {type(v).__name__}")


def _check_divisor(b: Any) -> None:
    # Python raises ZeroDivisionError where numpy warns and yields 0/inf/nan;
    # defer so the scalar interpreter reproduces the exact per-candidate error
    if isinstance(b, np.ndarray):
        if (b == 0).any():
            raise MaskCompileError("zero divisor in block")
    elif b == 0:
        raise MaskCompileError("zero divisor in block")


def _eval_block(node, env: Mapping[str, Any]):
    kind = node[0]
    if kind == "lit":
        return node[1]
    if kind == "var":
        name = node[1].replace("-", "_")
        if name not in env:
            raise MaskCompileError(f"unknown strategy parameter ${node[1]}")
        return env[name]
    if kind in ("or", "and"):
        a = _truthy_block(_eval_block(node[1], env))
        if isinstance(a, bool):
            # block-constant left side: preserve Python's short-circuit
            if (kind == "or") == a:
                return a
            return _truthy_block(_eval_block(node[2], env))
        # per-candidate left side: the scalar interpreter would skip the
        # right side for some candidates, so any error there must defer to
        # the interpreter rather than poison the whole block
        try:
            b = _truthy_block(_eval_block(node[2], env))
        except (ZeroDivisionError, TypeError, KeyError, OverflowError) as e:
            raise MaskCompileError(f"short-circuit divergence: {e}") from None
        if kind == "or":
            return np.logical_or(a, b)
        return np.logical_and(a, b)
    if kind == "arith":
        op = node[1]
        a = _as_arith_operand(_eval_block(node[2], env))
        b = _as_arith_operand(_eval_block(node[3], env))
        if _is_plain_scalar(a) and _is_plain_scalar(b):
            return _eval(("arith", op, ("lit", a), ("lit", b)), {})
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            _check_divisor(b)
            return np.true_divide(a, b)
        _check_divisor(b)
        return np.mod(a, b)
    if kind == "cmp":
        op = node[1]
        a = _eval_block(node[2], env)
        b = _eval_block(node[3], env)
        if _is_plain_scalar(a) and _is_plain_scalar(b):
            return _eval(("cmp", op, ("lit", a), ("lit", b)), {})
        for x, y in ((a, b), (b, a)):
            if isinstance(x, CategoricalColumn):
                if isinstance(y, (np.ndarray, CategoricalColumn)):
                    raise MaskCompileError("comparison of two columns")
                if op == "=":
                    return x.lut(lambda v: v == y)
                if op == "!=":
                    return x.lut(lambda v: v != y)
                raise MaskCompileError("ordered comparison on categorical")
        # at least one numeric array remains; the other side is numeric,
        # or a non-numeric scalar (equality is then type-constant in Python)
        sides = (a, b)
        if all(
            _is_numeric_array(v)
            or (_is_plain_scalar(v) and isinstance(v, (bool, int, float)))
            for v in sides
        ):
            if op == "=":
                return np.equal(a, b)
            if op == "!=":
                return np.not_equal(a, b)
            if op == ">":
                return np.greater(a, b)
            if op == "<":
                return np.less(a, b)
            if op == ">=":
                return np.greater_equal(a, b)
            return np.less_equal(a, b)
        if op == "=":
            return False  # e.g. int column vs string literal: never equal
        if op == "!=":
            return True
        raise MaskCompileError("ordered comparison of mixed types")
    raise AssertionError(f"bad node {node!r}")


@dataclasses.dataclass(frozen=True)
class Rule:
    text: str
    ast: tuple = dataclasses.field(hash=False, compare=False, default=())

    @staticmethod
    def parse(text: str) -> "Rule":
        return Rule(text=text, ast=_Parser(tokenize(text)).parse())

    def matches(self, env: Mapping[str, Any]) -> bool:
        """True => the strategy hits this forbidden pattern (gets dropped)."""
        return _truthy(_eval(self.ast, env))

    def block_mask(self, env: Mapping[str, Any], n: int) -> np.ndarray:
        """Per-candidate ``matches`` over a block of ``n`` candidates.

        ``env`` maps parameter names to length-``n`` numpy columns,
        :class:`CategoricalColumn` code columns, or block-constant Python
        scalars. Raises :class:`MaskCompileError` whenever a faithful
        vectorization isn't possible — callers then fall back to
        :meth:`matches` per candidate.
        """
        v = _truthy_block(_eval_block(self.ast, env))
        if isinstance(v, bool):
            return np.full(n, v)
        if v.shape != (n,):
            v = np.broadcast_to(v, (n,)).copy()
        return v


class RuleFilter:
    """Applies the rule set: keep s iff r_j(s) == False for all j (Eq. 10)."""

    def __init__(self, rules: Sequence[str | Rule] = ()):
        self.rules = [r if isinstance(r, Rule) else Rule.parse(r) for r in rules]

    def is_valid(self, env: Mapping[str, Any]) -> bool:
        return all(not r.matches(env) for r in self.rules)

    def first_violation(self, env: Mapping[str, Any]) -> str | None:
        for r in self.rules:
            if r.matches(env):
                return r.text
        return None

    def block_violations(
        self,
        env: Mapping[str, Any],
        n: int,
        env_at: "Optional[Callable[[int], Mapping[str, Any]]]" = None,
    ) -> np.ndarray:
        """Boolean mask of candidates forbidden by *some* rule.

        Rules evaluate in order; a rule that cannot be block-evaluated
        (:class:`MaskCompileError`) re-runs through the scalar interpreter
        via ``env_at(i)`` — and only for candidates no earlier rule already
        forbade, reproducing ``is_valid``'s short-circuit exactly (including
        which candidates can observe an evaluation error). With no
        ``env_at`` the compile error propagates.
        """
        out = np.zeros(n, dtype=bool)
        for r in self.rules:
            try:
                m = r.block_mask(env, n)
            except MaskCompileError:
                if env_at is None:
                    raise
                m = np.fromiter(
                    (
                        (not out[i]) and bool(r.matches(env_at(i)))
                        for i in range(n)
                    ),
                    bool,
                    n,
                )
            np.logical_or(out, m, out=out)
        return out


# The paper's three example rules (§3.3) as the default rule set. Rule 1 is
# kept as published: flash-attn with *selective* recompute is redundant work
# (flash attention already avoids materializing the attention matrix).
DEFAULT_RULES = (
    "$use_flash_attn != none && $recompute_granularity = selective",
    "$recompute_num_layers > $pipeline_model_parallel_size",
    "$num_gpus % ($pipeline_model_parallel_size * $tensor_model_parallel_size) != 0",
)
