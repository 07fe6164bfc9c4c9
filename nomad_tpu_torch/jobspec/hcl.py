"""Generic HCL2-subset engine: tokenizer, recursive-descent parser, and
expression evaluator.

Behavioral reference: the reference consumes HCL2 via hashicorp/hcl/v2
(`jobspec2/parse.go:19`); this is a fresh Python implementation of the
subset the jobspec language needs — blocks with labels, attributes,
strings with `${...}` interpolation and `<<EOF` heredocs, lists, objects,
arithmetic/comparison/logical operators, ternary, indexing, attribute
traversal, and function calls. Unknown interpolation roots (``attr.*``,
``env.*``, ``node.*``, ``meta.*``, ``NOMAD_*``) are preserved literally so
runtime interpolation survives parsing, mirroring how the reference keeps
`${attr.kernel.name}` in constraint targets for the scheduler/client to
resolve (ref client/taskenv/env.go, scheduler/feasible.go:785).
"""
from __future__ import annotations

import base64
import json
import math
import re
from dataclasses import dataclass, field
from typing import Any, Optional


class HCLError(Exception):
    def __init__(self, msg: str, line: int = 0):
        super().__init__(f"line {line}: {msg}" if line else msg)
        self.line = line


# --------------------------------------------------------------------- lexer

_PUNCT = [
    "==", "!=", "<=", ">=", "&&", "||",
    "{", "}", "[", "]", "(", ")", "=", ",", ":", ".", "?",
    "+", "-", "*", "/", "%", "<", ">", "!",
]

_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_.-]*")
_NUM_RE = re.compile(r"\d+(\.\d+)?([eE][+-]?\d+)?")


@dataclass
class Token:
    kind: str          # ident | number | string | heredoc | punct | newline | eof
    value: Any
    line: int


def _scan_string(src: str, i: int, line: int) -> tuple[list, int]:
    """Scan a quoted string starting after the opening quote. Returns a list
    of parts: str literals and ("interp", source) tuples."""
    parts: list = []
    buf = []
    n = len(src)
    while i < n:
        c = src[i]
        if c == '"':
            if buf:
                parts.append("".join(buf))
            return parts, i + 1
        if c == "\\":
            if i + 1 >= n:
                raise HCLError("unterminated escape", line)
            e = src[i + 1]
            buf.append({"n": "\n", "t": "\t", "r": "\r", '"': '"',
                        "\\": "\\"}.get(e, e))
            i += 2
            continue
        if src[i:i + 3] == "$${":      # escaped interpolation
            buf.append("${")
            i += 3
            continue
        if src[i:i + 2] == "${":
            if buf:
                parts.append("".join(buf))
                buf = []
            depth = 1
            j = i + 2
            while j < n and depth:
                if src[j] == "{":
                    depth += 1
                elif src[j] == "}":
                    depth -= 1
                elif src[j] == '"':    # skip nested strings
                    j += 1
                    while j < n and src[j] != '"':
                        j += 2 if src[j] == "\\" else 1
                j += 1
            if depth:
                raise HCLError("unterminated interpolation", line)
            parts.append(("interp", src[i + 2:j - 1]))
            i = j
            continue
        if c == "\n":
            raise HCLError("newline in string", line)
        buf.append(c)
        i += 1
    raise HCLError("unterminated string", line)


def tokenize(src: str) -> list[Token]:
    toks: list[Token] = []
    i, n, line = 0, len(src), 1
    while i < n:
        c = src[i]
        if c in " \t\r":
            i += 1
            continue
        if c == "\n":
            toks.append(Token("newline", "\n", line))
            line += 1
            i += 1
            continue
        if c == "#" or src[i:i + 2] == "//":
            while i < n and src[i] != "\n":
                i += 1
            continue
        if src[i:i + 2] == "/*":
            j = src.find("*/", i + 2)
            if j < 0:
                raise HCLError("unterminated comment", line)
            line += src.count("\n", i, j)
            i = j + 2
            continue
        if src[i:i + 2] == "<<":
            indent = src[i + 2:i + 3] == "-"
            j = i + (3 if indent else 2)
            m = _IDENT_RE.match(src, j)
            if not m:
                raise HCLError("invalid heredoc marker", line)
            marker = m.group(0)
            j = src.find("\n", m.end())
            if j < 0:
                raise HCLError("unterminated heredoc", line)
            lines = []
            k = j + 1
            while True:
                e = src.find("\n", k)
                if e < 0:
                    raise HCLError(f"heredoc {marker} never closed", line)
                text = src[k:e]
                if text.strip() == marker:
                    break
                lines.append(text)
                k = e + 1
            body = "\n".join(lines) + ("\n" if lines else "")
            if indent:
                pad = min((len(l) - len(l.lstrip()) for l in lines if l.strip()),
                          default=0)
                body = "\n".join(l[pad:] for l in lines)
                body += "\n" if lines else ""
            toks.append(Token("heredoc", body, line))
            line += src.count("\n", i, e) + 1
            i = e + 1
            # heredoc consumes its trailing newline; emit one for the parser
            toks.append(Token("newline", "\n", line))
            continue
        if c == '"':
            parts, j = _scan_string(src, i + 1, line)
            toks.append(Token("string", parts, line))
            i = j
            continue
        m = _NUM_RE.match(src, i)
        if m and c.isdigit():
            text = m.group(0)
            toks.append(Token("number",
                              float(text) if ("." in text or "e" in text
                                              or "E" in text) else int(text),
                              line))
            i = m.end()
            continue
        m = _IDENT_RE.match(src, i)
        if m and (c.isalpha() or c == "_"):
            toks.append(Token("ident", m.group(0), line))
            i = m.end()
            continue
        for p in _PUNCT:
            if src.startswith(p, i):
                toks.append(Token("punct", p, line))
                i += len(p)
                break
        else:
            raise HCLError(f"unexpected character {c!r}", line)
    toks.append(Token("eof", None, line))
    return toks


# ----------------------------------------------------------------------- AST

@dataclass
class Attribute:
    name: str
    expr: Any
    line: int


@dataclass
class Block:
    type: str
    labels: list[str]
    body: "Body"
    line: int


@dataclass
class Body:
    items: list = field(default_factory=list)

    def blocks(self, type: str) -> list[Block]:
        return [b for b in self.items
                if isinstance(b, Block) and b.type == type]

    def attributes(self) -> dict[str, Attribute]:
        return {a.name: a for a in self.items if isinstance(a, Attribute)}


# expression nodes: tuples ("lit", v) ("tmpl", parts) ("list", [e]) ("obj",
# [(k,e)]) ("var", name) ("get", e, name) ("index", e, e) ("call", name, [e])
# ("un", op, e) ("bin", op, l, r) ("cond", c, t, f)


class Parser:
    def __init__(self, toks: list[Token]):
        self.toks = toks
        self.pos = 0

    def peek(self, skip_nl: bool = False) -> Token:
        p = self.pos
        if skip_nl:
            while self.toks[p].kind == "newline":
                p += 1
        return self.toks[p]

    def next(self, skip_nl: bool = False) -> Token:
        if skip_nl:
            while self.toks[self.pos].kind == "newline":
                self.pos += 1
        t = self.toks[self.pos]
        if t.kind != "eof":
            self.pos += 1
        return t

    def expect(self, kind: str, value=None, skip_nl: bool = False) -> Token:
        t = self.next(skip_nl=skip_nl)
        if t.kind != kind or (value is not None and t.value != value):
            raise HCLError(
                f"expected {value or kind}, got {t.value!r}", t.line)
        return t

    # ---- body

    def parse_body(self, top: bool = False) -> Body:
        body = Body()
        while True:
            t = self.peek(skip_nl=True)
            if t.kind == "eof":
                if not top:
                    raise HCLError("unexpected EOF in block", t.line)
                break
            if t.kind == "punct" and t.value == "}":
                if top:
                    raise HCLError("unexpected '}'", t.line)
                break
            if t.kind != "ident":
                raise HCLError(f"expected identifier, got {t.value!r}", t.line)
            name = self.next(skip_nl=True)
            nxt = self.peek()
            if nxt.kind == "punct" and nxt.value == "=":
                self.next()
                expr = self.parse_expr()
                body.items.append(Attribute(name.value, expr, name.line))
                continue
            # block: labels then '{'
            labels = []
            while True:
                t2 = self.peek()
                if t2.kind == "string":
                    lbl = self.next()
                    if any(isinstance(p, tuple) for p in lbl.value):
                        raise HCLError("block label cannot interpolate",
                                       lbl.line)
                    labels.append("".join(lbl.value))
                elif t2.kind == "ident":
                    labels.append(self.next().value)
                elif t2.kind == "punct" and t2.value == "{":
                    break
                else:
                    raise HCLError(
                        f"expected block label or '{{', got {t2.value!r}",
                        t2.line)
            self.expect("punct", "{")
            inner = self.parse_body()
            self.expect("punct", "}", skip_nl=True)
            body.items.append(Block(name.value, labels, inner, name.line))
        return body

    # ---- expressions (precedence climbing)

    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        cond = self.parse_or()
        t = self.peek()
        if t.kind == "punct" and t.value == "?":
            self.next()
            a = self.parse_expr()
            self.expect("punct", ":", skip_nl=True)
            b = self.parse_expr()
            return ("cond", cond, a, b)
        return cond

    def _binop(self, ops: tuple, sub):
        left = sub()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value in ops:
                op = self.next().value
                right = sub()
                left = ("bin", op, left, right)
            else:
                return left

    def parse_or(self):
        return self._binop(("||",), self.parse_and)

    def parse_and(self):
        return self._binop(("&&",), self.parse_eq)

    def parse_eq(self):
        return self._binop(("==", "!="), self.parse_cmp)

    def parse_cmp(self):
        return self._binop(("<", ">", "<=", ">="), self.parse_add)

    def parse_add(self):
        return self._binop(("+", "-"), self.parse_mul)

    def parse_mul(self):
        return self._binop(("*", "/", "%"), self.parse_unary)

    def parse_unary(self):
        t = self.peek()
        if t.kind == "punct" and t.value in ("!", "-"):
            self.next()
            return ("un", t.value, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value == ".":
                nxt = self.toks[self.pos + 1]
                if nxt.kind not in ("ident", "number"):
                    break
                self.next()
                attr = self.next()
                e = ("get", e, str(attr.value))
            elif t.kind == "punct" and t.value == "[":
                self.next()
                idx = self.parse_expr()
                self.expect("punct", "]", skip_nl=True)
                e = ("index", e, idx)
            else:
                break
        return e

    def parse_primary(self):
        t = self.next(skip_nl=True)
        if t.kind == "number":
            return ("lit", t.value)
        if t.kind == "heredoc":
            return ("lit", t.value)
        if t.kind == "string":
            if not t.value:
                return ("lit", "")
            if len(t.value) == 1 and isinstance(t.value[0], str):
                return ("lit", t.value[0])
            parts = []
            for p in t.value:
                if isinstance(p, str):
                    parts.append(("lit", p))
                else:
                    parts.append(("interp", parse_expression(p[1]), p[1]))
            return ("tmpl", parts)
        if t.kind == "ident":
            if t.value == "true":
                return ("lit", True)
            if t.value == "false":
                return ("lit", False)
            if t.value == "null":
                return ("lit", None)
            nxt = self.peek()
            if nxt.kind == "punct" and nxt.value == "(":
                self.next()
                args = []
                while True:
                    t2 = self.peek(skip_nl=True)
                    if t2.kind == "punct" and t2.value == ")":
                        self.next(skip_nl=True)
                        break
                    args.append(self.parse_expr())
                    t2 = self.peek(skip_nl=True)
                    if t2.kind == "punct" and t2.value == ",":
                        self.next(skip_nl=True)
                return ("call", t.value, args)
            # dotted idents lex as one token (foo.bar) — split into gets
            if "." in t.value:
                parts = t.value.split(".")
                e = ("var", parts[0])
                for p in parts[1:]:
                    e = ("get", e, p)
                return e
            return ("var", t.value)
        if t.kind == "punct" and t.value == "[":
            items = []
            while True:
                t2 = self.peek(skip_nl=True)
                if t2.kind == "punct" and t2.value == "]":
                    self.next(skip_nl=True)
                    break
                items.append(self.parse_expr())
                t2 = self.peek(skip_nl=True)
                if t2.kind == "punct" and t2.value == ",":
                    self.next(skip_nl=True)
            return ("list", items)
        if t.kind == "punct" and t.value == "{":
            pairs = []
            while True:
                t2 = self.peek(skip_nl=True)
                if t2.kind == "punct" and t2.value == "}":
                    self.next(skip_nl=True)
                    break
                key_tok = self.next(skip_nl=True)
                if key_tok.kind == "ident":
                    key = ("lit", key_tok.value)
                elif key_tok.kind == "string":
                    key = ("lit", "".join(p for p in key_tok.value
                                          if isinstance(p, str)))
                elif key_tok.kind == "punct" and key_tok.value == "(":
                    key = self.parse_expr()
                    self.expect("punct", ")")
                else:
                    raise HCLError(f"bad object key {key_tok.value!r}",
                                   key_tok.line)
                sep = self.next()
                if not (sep.kind == "punct" and sep.value in ("=", ":")):
                    raise HCLError("expected '=' or ':' in object", sep.line)
                val = self.parse_expr()
                pairs.append((key, val))
                t2 = self.peek(skip_nl=True)
                if t2.kind == "punct" and t2.value == ",":
                    self.next(skip_nl=True)
            return ("obj", pairs)
        if t.kind == "punct" and t.value == "(":
            e = self.parse_expr()
            self.expect("punct", ")", skip_nl=True)
            return e
        raise HCLError(f"unexpected token {t.value!r}", t.line)


def parse_expression(src: str):
    p = Parser(tokenize(src))
    e = p.parse_expr()
    t = p.peek(skip_nl=True)
    if t.kind != "eof":
        raise HCLError(f"trailing tokens in expression: {t.value!r}", t.line)
    return e


def parse(src: str) -> Body:
    return Parser(tokenize(src)).parse_body(top=True)


# ----------------------------------------------------------------- evaluator

def _std_functions() -> dict:
    def fmt(spec, *args):
        # translate %s/%d/%v/%.2f-style verbs to Python formatting
        out, ai = [], 0
        i = 0
        while i < len(spec):
            c = spec[i]
            if c == "%" and i + 1 < len(spec):
                m = re.match(r"%([-+0-9.]*)([sdfvq%])", spec[i:])
                if m:
                    flags, verb = m.groups()
                    if verb == "%":
                        out.append("%")
                    else:
                        a = args[ai]
                        ai += 1
                        if verb == "q":
                            out.append(json.dumps(str(a)))
                        elif verb == "d":
                            out.append(("%" + flags + "d") % int(a))
                        elif verb == "f":
                            out.append(("%" + flags + "f") % float(a))
                        else:
                            out.append(_to_string(a))
                    i += m.end()
                    continue
            out.append(c)
            i += 1
        return "".join(out)

    return {
        "abs": abs, "ceil": math.ceil, "floor": math.floor,
        "min": min, "max": max, "pow": pow,
        "format": fmt,
        "join": lambda sep, lst: sep.join(_to_string(x) for x in lst),
        "split": lambda sep, s: s.split(sep),
        "lower": lambda s: s.lower(),
        "upper": lambda s: s.upper(),
        "title": lambda s: s.title(),
        "trim": lambda s, cut: s.strip(cut),
        "trimspace": lambda s: s.strip(),
        "trimprefix": lambda s, p: s[len(p):] if s.startswith(p) else s,
        "trimsuffix": lambda s, p: s[:-len(p)] if p and s.endswith(p) else s,
        "replace": lambda s, a, b: s.replace(a, b),
        "regex_replace": lambda s, pat, rep: re.sub(pat, rep, s),
        "substr": lambda s, off, ln: s[off:] if ln < 0 else s[off:off + ln],
        "strlen": len, "length": len,
        "concat": lambda *ls: [x for l in ls for x in l],
        "contains": lambda lst, v: v in lst,
        "distinct": lambda lst: list(dict.fromkeys(lst)),
        "flatten": lambda lst: _flatten(lst),
        "reverse": lambda lst: list(reversed(lst)),
        "sort": lambda lst: sorted(lst),
        "range": lambda *a: list(range(*[int(x) for x in a])),
        "keys": lambda m: sorted(m.keys()),
        "values": lambda m: [m[k] for k in sorted(m.keys())],
        "merge": lambda *ms: {k: v for m in ms for k, v in m.items()},
        "lookup": lambda m, k, d=None: m.get(k, d),
        "element": lambda lst, i: lst[int(i) % len(lst)],
        "slice": lambda lst, a, b: lst[int(a):int(b)],
        "coalesce": lambda *a: next((x for x in a if x not in (None, "")),
                                    None),
        "compact": lambda lst: [x for x in lst if x not in (None, "")],
        "tonumber": lambda v: float(v) if "." in str(v) else int(v),
        "tostring": _to_string,
        "tolist": list, "toset": lambda l: list(dict.fromkeys(l)),
        "tomap": dict, "tobool": lambda v: v in (True, "true", "1", 1),
        "base64encode": lambda s: base64.b64encode(s.encode()).decode(),
        "base64decode": lambda s: base64.b64decode(s).decode(),
        "jsonencode": lambda v: json.dumps(v),
        "jsondecode": lambda s: json.loads(s),
        "yamlencode": lambda v: json.dumps(v),   # JSON is valid YAML
        "chomp": lambda s: s.rstrip("\n"),
        "indent": lambda n, s: s.replace("\n", "\n" + " " * int(n)),
        "startswith": lambda s, p: s.startswith(p),
        "endswith": lambda s, p: s.endswith(p),
        "parseint": lambda s, b: int(s, int(b)),
        "signum": lambda x: (x > 0) - (x < 0),
        "zipmap": lambda ks, vs: dict(zip(ks, vs)),
        "setunion": lambda *ls: list(dict.fromkeys(x for l in ls for x in l)),
    }


def _flatten(lst):
    out = []
    for x in lst:
        if isinstance(x, list):
            out.extend(_flatten(x))
        else:
            out.append(x)
    return out


def _to_string(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if v is None:
        return ""
    return str(v)


_STD_FUNCS = _std_functions()


class Unknown(Exception):
    """Raised when an expression references an unknown root variable —
    callers decide whether that's an error or a keep-literal situation."""

    def __init__(self, root: str):
        super().__init__(root)
        self.root = root


class EvalContext:
    def __init__(self, variables: Optional[dict] = None,
                 functions: Optional[dict] = None):
        self.variables = variables or {}
        self.functions = dict(_STD_FUNCS)
        if functions:
            self.functions.update(functions)

    def child(self, **more) -> "EvalContext":
        v = dict(self.variables)
        v.update(more)
        return EvalContext(v, self.functions)

    def evaluate(self, expr) -> Any:
        kind = expr[0]
        if kind == "lit":
            return expr[1]
        if kind == "tmpl":
            out = []
            for p in expr[1]:
                if p[0] == "lit":
                    out.append(p[1])
                else:   # ("interp", ast, src)
                    try:
                        out.append(_to_string(self.evaluate(p[1])))
                    except Unknown:
                        # preserve runtime interpolation literally
                        out.append("${" + p[2] + "}")
            return "".join(out)
        if kind == "list":
            return [self.evaluate(e) for e in expr[1]]
        if kind == "obj":
            return {_to_string(self.evaluate(k)): self.evaluate(v)
                    for k, v in expr[1]}
        if kind == "var":
            name = expr[1]
            if name in self.variables:
                return self.variables[name]
            raise Unknown(name)
        if kind == "get":
            base = self.evaluate(expr[1])
            if isinstance(base, dict):
                if expr[2] in base:
                    return base[expr[2]]
                raise HCLError(f"object has no attribute {expr[2]!r}")
            raise HCLError(f"cannot access .{expr[2]} on {type(base).__name__}")
        if kind == "index":
            base = self.evaluate(expr[1])
            idx = self.evaluate(expr[2])
            if isinstance(base, list):
                return base[int(idx)]
            return base[idx]
        if kind == "call":
            fn = self.functions.get(expr[1])
            if fn is None:
                raise HCLError(f"unknown function {expr[1]!r}")
            args = [self.evaluate(a) for a in expr[2]]
            return fn(*args)
        if kind == "cond":
            return (self.evaluate(expr[2]) if self.evaluate(expr[1])
                    else self.evaluate(expr[3]))
        if kind == "un":
            v = self.evaluate(expr[2])
            return (not v) if expr[1] == "!" else -v
        if kind == "bin":
            op, l, r = expr[1], expr[2], expr[3]
            if op == "&&":
                return bool(self.evaluate(l)) and bool(self.evaluate(r))
            if op == "||":
                return bool(self.evaluate(l)) or bool(self.evaluate(r))
            a, b = self.evaluate(l), self.evaluate(r)
            if op == "+":
                return a + b
            if op == "-":
                return a - b
            if op == "*":
                return a * b
            if op == "/":
                return a / b
            if op == "%":
                return a % b
            if op == "==":
                return a == b
            if op == "!=":
                return a != b
            if op == "<":
                return a < b
            if op == ">":
                return a > b
            if op == "<=":
                return a <= b
            if op == ">=":
                return a >= b
        raise HCLError(f"bad expression node {kind!r}")
