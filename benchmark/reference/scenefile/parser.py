"""Recursive-descent parser + AST + tree-walking interpreter for the SLR DSL.

Python reimplementation of the bison grammar (SceneParser.yy:114-263) and the
AST `perform()` interpreter (SceneParser.{hpp,cpp}): C-like statements,
`if/else`, `for`, user `function` definitions with defaulted arguments,
`return`, tuples `(a, "key": value)`, tuple indexing `t[i]`, the full operator
set with the reference's precedence (SceneParser.yy:100-110).

Values are plain Python objects; named-vs-positional parameter matching and
`Tuple` semantics mirror ParameterList (SceneParser.hpp:220-273).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from .lexer import Token, tokenize


class DSLError(Exception):
    pass


# ---------------------------------------------------------------------------
# Runtime values
# ---------------------------------------------------------------------------

class TupleVal:
    """Ordered parameter list with optional names (reference ParameterList)."""

    def __init__(self, items: list[tuple[Optional[str], Any]] | None = None):
        self.items: list[tuple[Optional[str], Any]] = list(items or [])

    def add(self, key: Optional[str], value: Any) -> None:
        self.items.append((key or None, value))

    def __len__(self) -> int:
        return len(self.items)

    def positional(self) -> list[Any]:
        return [v for k, v in self.items if k is None]

    def named(self) -> dict[str, Any]:
        return {k: v for k, v in self.items if k is not None}

    def __getitem__(self, i: int) -> Any:
        return self.items[i][1]

    def __repr__(self) -> str:
        parts = [f"{k}: {v!r}" if k else repr(v) for k, v in self.items]
        return "(" + ", ".join(parts) + ")"


@dataclasses.dataclass
class UserFunction:
    """`function name(a, b = default) { ... }` (FunctionDefinitionStatement)."""

    name: str
    params: list[tuple[str, Any]]  # (name, default AST or None)
    body: "Stmt"
    env: "Env"

    def __call__(self, args: TupleVal, ctx) -> Any:
        local = Env(parent=self.env)
        pos = args.positional()
        named = args.named()
        for i, (pname, default) in enumerate(self.params):
            if pname in named:
                local.define(pname, named[pname])
            elif i < len(pos):
                local.define(pname, pos[i])
            elif default is not None:
                local.define(pname, default.eval(local, ctx))
            else:
                raise DSLError(f"function {self.name}: missing argument {pname}")
        try:
            self.body.exec(local, ctx)
        except _ReturnSignal as r:
            return r.value
        return None


class Env:
    """Scoped variable stack (reference LocalVariables, SceneParser.hpp:338)."""

    def __init__(self, parent: Optional["Env"] = None):
        self.vars: dict[str, Any] = {}
        self.parent = parent

    def lookup(self, name: str) -> Any:
        env = self
        while env is not None:
            if name in env.vars:
                return env.vars[name]
            env = env.parent
        raise DSLError(f"undefined variable: {name}")

    def define(self, name: str, value: Any) -> None:
        self.vars[name] = value

    def assign(self, name: str, value: Any) -> None:
        env = self
        while env is not None:
            if name in env.vars:
                env.vars[name] = value
                return
            env = env.parent
        # new variable in current scope (DSL has no declarations)
        self.vars[name] = value


class _ReturnSignal(Exception):
    def __init__(self, value: Any):
        self.value = value


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

class Stmt:
    def exec(self, env: Env, ctx) -> None:
        raise NotImplementedError


class Expr:
    def eval(self, env: Env, ctx) -> Any:
        raise NotImplementedError


@dataclasses.dataclass
class ExprStmt(Stmt):
    expr: Expr

    def exec(self, env, ctx):
        self.expr.eval(env, ctx)


@dataclasses.dataclass
class Block(Stmt):
    stmts: list

    def exec(self, env, ctx):
        inner = Env(parent=env)
        for s in self.stmts:
            s.exec(inner, ctx)


@dataclasses.dataclass
class IfElse(Stmt):
    cond: Expr
    then: Stmt
    otherwise: Optional[Stmt]

    def exec(self, env, ctx):
        if _truthy(self.cond.eval(env, ctx)):
            self.then.exec(env, ctx)
        elif self.otherwise is not None:
            self.otherwise.exec(env, ctx)


@dataclasses.dataclass
class ForLoop(Stmt):
    init: Expr
    cond: Expr
    step: Expr
    body: Stmt

    def exec(self, env, ctx):
        inner = Env(parent=env)
        self.init.eval(inner, ctx)
        while _truthy(self.cond.eval(inner, ctx)):
            self.body.exec(inner, ctx)
            self.step.eval(inner, ctx)


@dataclasses.dataclass
class FunctionDef(Stmt):
    name: str
    params: list
    body: Stmt

    def exec(self, env, ctx):
        env.define(self.name, UserFunction(self.name, self.params, self.body, env))


@dataclasses.dataclass
class Return(Stmt):
    expr: Optional[Expr]

    def exec(self, env, ctx):
        raise _ReturnSignal(None if self.expr is None else self.expr.eval(env, ctx))


@dataclasses.dataclass
class Literal(Expr):
    value: Any

    def eval(self, env, ctx):
        return self.value


@dataclasses.dataclass
class Variable(Expr):
    name: str

    def eval(self, env, ctx):
        return env.lookup(self.name)


@dataclasses.dataclass
class TupleExpr(Expr):
    params: list  # list of (key Expr or None, value Expr)

    def eval(self, env, ctx):
        t = TupleVal()
        for key, val in self.params:
            k = key.eval(env, ctx) if key is not None else None
            t.add(k, val.eval(env, ctx))
        return t


@dataclasses.dataclass
class Index(Expr):
    base: Expr
    index: Expr

    def eval(self, env, ctx):
        base = self.base.eval(env, ctx)
        idx = self.index.eval(env, ctx)
        if isinstance(base, TupleVal):
            if isinstance(idx, str):
                return base.named()[idx]
            return base[int(idx)]
        return base[int(idx)]


@dataclasses.dataclass
class Call(Expr):
    name: str
    args: list  # list of (key Expr or None, value Expr)

    def eval(self, env, ctx):
        fn = env.lookup(self.name)
        t = TupleVal()
        for key, val in self.args:
            k = key.eval(env, ctx) if key is not None else None
            t.add(k, val.eval(env, ctx))
        if isinstance(fn, UserFunction):
            return fn(t, ctx)
        if callable(fn):
            return fn(t, ctx)
        raise DSLError(f"{self.name} is not callable")


@dataclasses.dataclass
class Unary(Expr):
    op: str
    operand: Expr

    def eval(self, env, ctx):
        v = self.operand.eval(env, ctx)
        if self.op == "-":
            return -v
        if self.op == "+":
            return v
        if self.op == "!":
            return not _truthy(v)
        raise DSLError(f"bad unary {self.op}")


@dataclasses.dataclass
class IncDec(Expr):
    op: str   # "++*", "--*", "*++", "*--" (pre/post)
    name: str

    def eval(self, env, ctx):
        old = env.lookup(self.name)
        new = old + 1 if "++" in self.op else old - 1
        env.assign(self.name, new)
        return new if self.op.startswith(("++", "--")) else old


@dataclasses.dataclass
class Binary(Expr):
    left: Expr
    op: str
    right: Expr

    def eval(self, env, ctx):
        op = self.op
        if op == "&&":
            return _truthy(self.left.eval(env, ctx)) and _truthy(
                self.right.eval(env, ctx)
            )
        if op == "||":
            return _truthy(self.left.eval(env, ctx)) or _truthy(
                self.right.eval(env, ctx)
            )
        a = self.left.eval(env, ctx)
        b = self.right.eval(env, ctx)
        return apply_binary(a, op, b)


@dataclasses.dataclass
class Assign(Expr):
    name: str
    op: str
    expr: Expr

    def eval(self, env, ctx):
        v = self.expr.eval(env, ctx)
        if self.op != "=":
            old = env.lookup(self.name)
            v = apply_binary(old, self.op[0], v)
        env.assign(self.name, v)
        return v


def _truthy(v: Any) -> bool:
    return bool(v)


def apply_binary(a: Any, op: str, b: Any) -> Any:
    """Operator dispatch incl. matrix composition and spectrum scaling
    (reference TypeInfo operator tables, SceneParser.cpp)."""
    if op == "*":
        if isinstance(a, np.ndarray) and a.shape == (4, 4) and isinstance(
            b, np.ndarray
        ) and b.shape == (4, 4):
            return a @ b
        if hasattr(a, "scaled") and isinstance(b, (int, float)):
            return a.scaled(float(b))
        if isinstance(a, (int, float)) and hasattr(b, "scaled"):
            return b.scaled(float(a))
        if isinstance(a, np.ndarray) and a.shape == (4, 4) and hasattr(
            b, "position"
        ) and hasattr(b, "normal"):
            # Matrix * Vertex -> transformed vertex (reference TypeInfo
            # Matrix x Vertex operator; used e.g. IBL_Test.txt:50-53).
            lin = a[:3, :3]
            inv_t = np.linalg.inv(lin).T
            n = np.asarray(b.normal, np.float32) @ inv_t.T
            n = n / max(float(np.linalg.norm(n)), 1e-20)
            t = np.asarray(b.tangent, np.float32) @ lin.T
            t = t / max(float(np.linalg.norm(t)), 1e-20)
            return type(b)(
                position=(np.asarray(b.position, np.float32) @ lin.T
                          + a[:3, 3]).astype(np.float32),
                normal=n.astype(np.float32),
                tangent=t.astype(np.float32),
                uv=np.asarray(b.uv, np.float32),
            )
        return a * b
    if op == "/":
        if hasattr(a, "scaled") and isinstance(b, (int, float)):
            return a.scaled(1.0 / float(b))
        if isinstance(a, int) and isinstance(b, int):
            return a / b  # DSL '/' on ints is real division? keep float
        return a / b
    if op == "%":
        return a % b
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "<":
        return a < b
    if op == ">":
        return a > b
    if op == "<=":
        return a <= b
    if op == ">=":
        return a >= b
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    raise DSLError(f"bad operator {op}")


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_CMP_OPS = {"<", ">", "<=", ">=", "==", "!="}
_ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%="}


class Parser:
    def __init__(self, src: str):
        self.tokens = list(tokenize(src))
        self.pos = 0

    def peek(self, ahead: int = 0) -> Token:
        return self.tokens[min(self.pos + ahead, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.pos]
        self.pos += 1
        return t

    def expect(self, kind: str) -> Token:
        t = self.next()
        if t.kind != kind:
            raise DSLError(f"line {t.line}: expected {kind!r}, got {t.kind!r} ({t.value!r})")
        return t

    def parse(self) -> list[Stmt]:
        stmts = []
        while self.peek().kind != "eof":
            stmts.append(self.statement())
        return stmts

    # -- statements ---------------------------------------------------------
    def statement(self) -> Stmt:
        t = self.peek()
        if t.kind == "{":
            self.next()
            stmts = []
            while self.peek().kind != "}":
                stmts.append(self.statement())
            self.next()
            return Block(stmts)
        if t.kind == "if":
            self.next()
            self.expect("(")
            cond = self.expression()
            self.expect(")")
            then = self.statement()
            otherwise = None
            if self.peek().kind == "else":
                self.next()
                otherwise = self.statement()
            return IfElse(cond, then, otherwise)
        if t.kind == "for":
            self.next()
            self.expect("(")
            init = self.expression()
            self.expect(";")
            cond = self.expression()
            self.expect(";")
            step = self.expression()
            self.expect(")")
            body = self.statement()
            return ForLoop(init, cond, step, body)
        if t.kind == "function":
            self.next()
            name = self.expect("id").value
            self.expect("(")
            params = []
            while self.peek().kind != ")":
                pname = self.expect("id").value
                default = None
                if self.peek().kind == "=":
                    self.next()
                    default = self.expression()
                params.append((pname, default))
                if self.peek().kind == ",":
                    self.next()
            self.next()
            body = self.statement()
            return FunctionDef(name, params, body)
        if t.kind == "return":
            self.next()
            if self.peek().kind == ";":
                self.next()
                return Return(None)
            e = self.expression()
            self.expect(";")
            return Return(e)
        e = self.expression()
        self.expect(";")
        return ExprStmt(e)

    # -- expressions --------------------------------------------------------
    def expression(self) -> Expr:
        # assignment: ID <assign-op> Expression
        if self.peek().kind == "id" and self.peek(1).kind in _ASSIGN_OPS:
            name = self.next().value
            op = self.next().kind
            return Assign(name, op, self.expression())
        return self.logic_or()

    def logic_or(self) -> Expr:
        e = self.logic_and()
        while self.peek().kind == "||":
            self.next()
            e = Binary(e, "||", self.logic_and())
        return e

    def logic_and(self) -> Expr:
        e = self.equality()
        while self.peek().kind == "&&":
            self.next()
            e = Binary(e, "&&", self.equality())
        return e

    def equality(self) -> Expr:
        e = self.relational()
        while self.peek().kind in ("==", "!="):
            op = self.next().kind
            e = Binary(e, op, self.relational())
        return e

    def relational(self) -> Expr:
        e = self.additive()
        while self.peek().kind in ("<", ">", "<=", ">="):
            op = self.next().kind
            e = Binary(e, op, self.additive())
        return e

    def additive(self) -> Expr:
        e = self.multiplicative()
        while self.peek().kind in ("+", "-"):
            op = self.next().kind
            e = Binary(e, op, self.multiplicative())
        return e

    def multiplicative(self) -> Expr:
        e = self.unary()
        while self.peek().kind in ("*", "/", "%"):
            op = self.next().kind
            e = Binary(e, op, self.unary())
        return e

    def unary(self) -> Expr:
        t = self.peek()
        if t.kind in ("+", "-", "!"):
            self.next()
            return Unary(t.kind, self.unary())
        if t.kind in ("++", "--"):
            self.next()
            name = self.expect("id").value
            return IncDec(t.kind + "*", name)
        return self.postfix()

    def postfix(self) -> Expr:
        e = self.single_term()
        while True:
            t = self.peek()
            if t.kind == "[":
                self.next()
                idx = self.expression()
                self.expect("]")
                e = Index(e, idx)
            elif t.kind in ("++", "--") and isinstance(e, Variable):
                self.next()
                e = IncDec("*" + t.kind, e.name)
            else:
                break
        return e

    def single_term(self) -> Expr:
        t = self.peek()
        if t.kind == "id" and self.peek(1).kind == "(":
            name = self.next().value
            self.next()  # (
            args = self.arguments()
            self.expect(")")
            return Call(name, args)
        if t.kind == "id":
            self.next()
            return Variable(t.value)
        if t.kind == "int":
            self.next()
            return Literal(int(t.value))
        if t.kind == "real":
            self.next()
            return Literal(float(t.value))
        if t.kind == "string":
            self.next()
            return Literal(t.value)
        if t.kind == "bool":
            self.next()
            return Literal(t.value == "true")
        if t.kind == "(":
            return self.paren_or_tuple()
        raise DSLError(f"line {t.line}: unexpected token {t.kind!r} ({t.value!r})")

    def parameter(self) -> tuple:
        """Parameter: Expression [":" Expression] -> (key_expr|None, value)."""
        e = self.expression()
        if self.peek().kind == ":":
            self.next()
            v = self.expression()
            return (e, v)
        return (None, e)

    def arguments(self) -> list:
        args = []
        if self.peek().kind == ")":
            return args
        args.append(self.parameter())
        while self.peek().kind == ",":
            self.next()
            if self.peek().kind == ")":
                break
            args.append(self.parameter())
        return args

    def paren_or_tuple(self) -> Expr:
        """Disambiguate `(expr)` vs tuples (SceneParser.yy TupleValue)."""
        self.expect("(")
        if self.peek().kind == ",":  # "(,)" empty tuple
            self.next()
            self.expect(")")
            return TupleExpr([])
        first = self.parameter()
        if self.peek().kind == ")":
            self.next()
            if first[0] is None:
                return first[1]  # plain parenthesized expression
            return TupleExpr([first])  # ("k": v) — accept as 1-tuple
        params = [first]
        while self.peek().kind == ",":
            self.next()
            if self.peek().kind == ")":
                break
            params.append(self.parameter())
        self.expect(")")
        return TupleExpr(params)


def parse(src: str) -> list[Stmt]:
    return Parser(src).parse()


def execute(src: str, globals_env: Env, ctx) -> None:
    """Parse and run a scene script (reference readScene, API.cpp:84-97)."""
    for stmt in parse(src):
        stmt.exec(globals_env, ctx)
