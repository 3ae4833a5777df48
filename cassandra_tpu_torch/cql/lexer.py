"""CQL tokenizer.

Reference counterpart: the ANTLR lexer (src/antlr/Lexer.g). Hand-written
here: CQL's token set is small and a generated lexer buys nothing on this
path. Supports: identifiers ("quoted" preserves case), string literals
('' escape and $$..$$ bodies), integers/floats (incl. exponent), hex blobs
(0x..), uuids, bind markers (? and :name), operators, and -- // /* */
comments.
"""
from __future__ import annotations

import re
import uuid as uuid_mod
from dataclasses import dataclass

KEYWORDS = {
    "select", "from", "where", "and", "insert", "into", "values", "update",
    "set", "delete", "create", "drop", "alter", "table", "keyspace", "use",
    "primary", "key", "if", "not", "exists", "with", "limit", "order",
    "by", "asc", "desc", "allow", "filtering", "begin", "batch", "apply",
    "unlogged", "logged", "counter", "truncate", "in", "using", "ttl",
    "timestamp", "type", "index", "on", "add", "to", "rename", "static",
    "distinct", "as", "contains", "per", "partition", "is", "null", "token",
    "or", "replace", "materialized", "view", "custom", "options", "role",
    "user", "grant", "revoke", "of", "list", "function", "aggregate",
    "returns", "language", "trigger", "like",
}

UUID_RE = re.compile(
    r"[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}"
    r"-[0-9a-fA-F]{4}-[0-9a-fA-F]{12}")


@dataclass
class Token:
    kind: str     # IDENT KEYWORD STRING INT FLOAT HEX UUID OP MARKER EOF
    value: object
    pos: int

    def __repr__(self):
        return f"{self.kind}:{self.value!r}"


class LexError(ValueError):
    pass


def tokenize(text: str) -> list[Token]:
    out: list[Token] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        if text.startswith("--", i) or text.startswith("//", i):
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if text.startswith("/*", i):
            j = text.find("*/", i)
            if j < 0:
                raise LexError(f"unterminated comment at {i}")
            i = j + 2
            continue
        m = UUID_RE.match(text, i)
        if m:
            out.append(Token("UUID", uuid_mod.UUID(m.group()), i))
            i = m.end()
            continue
        if c == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise LexError(f"unterminated string at {i}")
                if text[j] == "'":
                    if j + 1 < n and text[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(text[j])
                j += 1
            out.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        if text.startswith("$$", i):
            j = text.find("$$", i + 2)
            if j < 0:
                raise LexError(f"unterminated $$ string at {i}")
            out.append(Token("STRING", text[i + 2:j], i))
            i = j + 2
            continue
        if c == '"':
            j = text.find('"', i + 1)
            if j < 0:
                raise LexError(f"unterminated quoted identifier at {i}")
            out.append(Token("IDENT", text[i + 1:j], i))
            i = j + 1
            continue
        if text.startswith("0x", i) or text.startswith("0X", i):
            j = i + 2
            while j < n and text[j] in "0123456789abcdefABCDEF":
                j += 1
            out.append(Token("HEX", bytes.fromhex(text[i + 2:j]), i))
            i = j
            continue
        if c.isdigit() or (c == "-" and i + 1 < n and text[i + 1].isdigit()
                           and _prev_is_operand_start(out)):
            m = re.match(r"-?\d+\.\d*(?:[eE][+-]?\d+)?|-?\d+[eE][+-]?\d+|-?\d+",
                         text[i:])
            lit = m.group()
            if "." in lit or "e" in lit or "E" in lit:
                out.append(Token("FLOAT", float(lit), i))
            else:
                out.append(Token("INT", int(lit), i))
            i += len(lit)
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            word = text[i:j]
            low = word.lower()
            if low in KEYWORDS:
                out.append(Token("KEYWORD", low, i))
            else:
                out.append(Token("IDENT", low, i))  # unquoted: case-folded
            i = j
            continue
        if c == "?":
            out.append(Token("MARKER", None, i))
            i += 1
            continue
        if c == ":" and i + 1 < n and (text[i + 1].isalpha()
                                       or text[i + 1] == "_"):
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            out.append(Token("MARKER", text[i + 1:j].lower(), i))
            i = j
            continue
        for op in ("<=", ">=", "!=", "+=", "-="):
            if text.startswith(op, i):
                out.append(Token("OP", op, i))
                i += 2
                break
        else:
            if c in "()[]{},.;=<>*+-/%:":
                out.append(Token("OP", c, i))
                i += 1
            else:
                raise LexError(f"unexpected character {c!r} at {i}")
    out.append(Token("EOF", None, n))
    return out


def _prev_is_operand_start(out: list[Token]) -> bool:
    """'-5' is a negative literal only where an operand may start."""
    if not out:
        return True
    t = out[-1]
    return not (t.kind in ("INT", "FLOAT", "IDENT", "UUID", "HEX", "STRING")
                or (t.kind == "OP" and t.value in (")", "]")))
