"""Query-language parser: ``"super AND cool~1 OR field:(a b)"`` -> UserAST.
The port's copy of ``veloci_tpu/query/parser.py``.

Hand-written lexer + recursive-descent parser reproducing the reference's
query_parser crate:

* lexer: query_parser/src/lexer.rs — tokens are Literal /
  AttributeLiteral (literal followed by ``:``), parentheses, tilde, and the
  whitespace-delimited keywords AND / OR; quoted phrases become single
  literals (quotes stripped, no escaping).
* parser: query_parser/src/parser.rs — binary clauses right-nested, adjacent
  literals OR-connected by default, ``attr:(...)`` attributes a subtree,
  ``term~N`` sets a levenshtein distance.
* AST ops: query_parser/src/ast.rs — `filter_ast` (stopword removal),
  `get_phrase_pairs` (adjacent-term pairs).

`Options` lets callers disable attributes / parentheses / levenshtein
(query_parser/src/lib.rs:44-57).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Set, Tuple

from ..error import VelociError

__all__ = [
    "Options",
    "ParseError",
    "UserAST",
    "UserFilter",
    "parse_with_opt",
]


class ParseError(VelociError):
    pass


@dataclass
class Options:
    no_attributes: bool = False
    no_parentheses: bool = False
    no_levensthein: bool = False


@dataclass
class UserFilter:
    phrase: str
    levenshtein: Optional[int] = None

    def __repr__(self) -> str:
        if self.levenshtein is not None:
            return f'"{self.phrase}"~{self.levenshtein}'
        return f'"{self.phrase}"'


class UserAST:
    """Attributed(attr, ast) | BinaryClause(left, op, right) | Leaf(filter)."""

    __slots__ = ("kind", "attr", "left", "op", "right", "filter")

    ATTRIBUTED = "attributed"
    BINARY = "binary"
    LEAF = "leaf"

    def __init__(self, kind, attr=None, left=None, op=None, right=None, filt=None):
        self.kind = kind
        self.attr = attr
        self.left = left
        self.op = op
        self.right = right
        self.filter = filt

    @classmethod
    def leaf(cls, phrase: str, levenshtein: Optional[int] = None) -> "UserAST":
        return cls(cls.LEAF, filt=UserFilter(phrase, levenshtein))

    @classmethod
    def attributed(cls, attr: str, ast: "UserAST") -> "UserAST":
        return cls(cls.ATTRIBUTED, attr=attr, left=ast)

    @classmethod
    def binary(cls, left: "UserAST", op: str, right: "UserAST") -> "UserAST":
        return cls(cls.BINARY, left=left, op=op, right=right)

    def __eq__(self, other) -> bool:
        if not isinstance(other, UserAST) or self.kind != other.kind:
            return NotImplemented if not isinstance(other, UserAST) else False
        if self.kind == self.LEAF:
            return self.filter == other.filter
        if self.kind == self.ATTRIBUTED:
            return self.attr == other.attr and self.left == other.left
        return (
            self.left == other.left
            and self.op == other.op
            and self.right == other.right
        )

    def __repr__(self) -> str:
        if self.kind == self.LEAF:
            return repr(self.filter)
        if self.kind == self.ATTRIBUTED:
            return f"{self.attr}:{self.left!r}"
        return f"({self.left!r} {self.op} {self.right!r})"

    # ---- AST utilities (reference ast.rs) -------------------------------
    def filter_ast(
        self,
        should_filter: Callable[["UserAST", Optional[str]], bool],
        current_attr: Optional[str] = None,
    ) -> Optional["UserAST"]:
        """Remove subtrees flagged by the callback (ast.rs:74-110)."""
        if should_filter(self, current_attr):
            return None
        if self.kind == self.ATTRIBUTED:
            sub = self.left.filter_ast(should_filter, self.attr)
            return UserAST.attributed(self.attr, sub) if sub is not None else None
        if self.kind == self.BINARY:
            f1 = self.left.filter_ast(should_filter, current_attr)
            f2 = self.right.filter_ast(should_filter, current_attr)
            if f1 is not None and f2 is not None:
                return UserAST.binary(f1, self.op, f2)
            return f1 if f1 is not None else f2
        return self

    def get_phrase_pairs(self) -> Set[Tuple[str, str]]:
        """Adjacent-term pairs for phrase boosting (ast.rs:122-155)."""
        collect: Set[Tuple[str, str]] = set()
        self._phrase_pairs(collect, [None], None)
        return collect

    def _phrase_pairs(self, collect, last_term, curr_attr) -> None:
        if self.kind == self.ATTRIBUTED:
            if curr_attr == self.attr or curr_attr is None:
                self.left._phrase_pairs(collect, last_term, self.attr)
            else:
                self.left._phrase_pairs(collect, [None], self.attr)
        elif self.kind == self.BINARY:
            self.left._phrase_pairs(collect, last_term, curr_attr)
            self.right._phrase_pairs(collect, last_term, curr_attr)
        else:
            if last_term[0] is not None:
                collect.add((last_term[0], self.filter.phrase))
            last_term[0] = self.filter.phrase


# ------------------------------------------------------------------ lexer

ATTR = "attr"
LITERAL = "lit"
OPEN = "("
CLOSE = ")"
TILDE = "~"
OR = "OR"
AND = "AND"


@dataclass
class _Token:
    type: str
    text: str


def _lex(text: str, options: Options) -> List[_Token]:
    """Reference query_parser/src/lexer.rs."""
    chars = list(text)
    tokens: List[_Token] = []
    i = 0
    n = len(chars)

    def is_separator(c: str) -> bool:
        if c in "()" and not options.no_parentheses:
            return True
        if c == "~" and not options.no_levensthein:
            return True
        if c == ":" and not options.no_attributes:
            return True
        return False

    while i < n:
        while i < n and chars[i].isspace():
            i += 1
        if i >= n:
            break
        c = chars[i]
        # NB: at string start prev_char_is_whitespace() is FALSE in the
        # reference (lexer.rs:214-216) — a leading "AND " is a literal
        prev_ws = i > 0 and chars[i - 1].isspace()

        # AND / OR keywords require trailing whitespace and a preceding space
        if prev_ws and text[i : i + 4] == "AND " :
            tokens.append(_Token(AND, "AND"))
            i += 3
            continue
        if prev_ws and text[i : i + 3] == "OR ":
            tokens.append(_Token(OR, "OR"))
            i += 2
            continue

        if c == '"':
            i += 1
            start = i
            while i < n and chars[i] != '"':
                i += 1
            phrase = text[start:i]
            i += 1  # closing quote
            if i < n and chars[i] == ":" and not options.no_attributes:
                i += 1
                tokens.append(_Token(ATTR, phrase))
            else:
                tokens.append(_Token(LITERAL, phrase))
            continue

        if c == "(" and not options.no_parentheses:
            tokens.append(_Token(OPEN, "("))
            i += 1
            continue
        if c == ")" and not options.no_parentheses:
            tokens.append(_Token(CLOSE, ")"))
            i += 1
            continue
        if c == "~" and not options.no_levensthein:
            tokens.append(_Token(TILDE, "~"))
            i += 1
            continue

        start = i
        i += 1
        while i < n and not chars[i].isspace() and not is_separator(chars[i]):
            i += 1
        word = text[start:i]
        if i < n and chars[i] == ":" and not options.no_attributes:
            i += 1
            tokens.append(_Token(ATTR, word))
        else:
            tokens.append(_Token(LITERAL, word))
    return tokens


# ------------------------------------------------------------------ parser


class _Parser:
    """Reference query_parser/src/parser.rs."""

    def __init__(self, text: str, options: Options):
        self.tokens = _lex(text, options)
        self.pos = 0
        self.text = text

    def peek(self) -> Optional[str]:
        if self.pos < len(self.tokens):
            return self.tokens[self.pos].type
        return None

    def next_token(self) -> _Token:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def parse_user_filter(self, tok: _Token) -> UserFilter:
        filt = UserFilter(phrase=tok.text)
        if self.peek() == TILDE:
            self.next_token()
            if self.peek() != LITERAL:
                raise ParseError("Expecting a levenshtein number after a '~' ")
            lev_tok = self.next_token()
            try:
                filt.levenshtein = int(lev_tok.text)
            except ValueError:
                raise ParseError(
                    f"Expected number after tilde to define levenshtein distance "
                    f"but got {lev_tok.text!r}"
                )
        return filt

    def parse_sub_expression(self, curr_ast: UserAST) -> UserAST:
        t = self.peek()
        if t is None or t == CLOSE:
            return curr_ast
        if t in (ATTR, LITERAL):
            return UserAST.binary(curr_ast, "OR", self._parse())
        if t == OR:
            self.next_token()
            return UserAST.binary(curr_ast, "OR", self._parse())
        if t == AND:
            self.next_token()
            return UserAST.binary(curr_ast, "AND", self._parse())
        raise ParseError(f"Unexpected token_type, got {t!r}")

    def _parse(self) -> UserAST:
        if self.pos >= len(self.tokens):
            raise ParseError("unexpected end of query")
        tok = self.next_token()
        if tok.type == ATTR:
            t = self.peek()
            if t == OPEN:
                return UserAST.attributed(tok.text, self._parse())
            if t == LITERAL:
                tok2 = self.next_token()
                filt = self.parse_user_filter(tok2)
                attributed = UserAST.attributed(
                    tok.text, UserAST(UserAST.LEAF, filt=filt)
                )
                return self.parse_sub_expression(attributed)
            raise ParseError("only token or ( allowed after attribute ('attr:') ")
        if tok.type == LITERAL:
            filt = self.parse_user_filter(tok)
            return self.parse_sub_expression(UserAST(UserAST.LEAF, filt=filt))
        if tok.type == OPEN:
            inner = self._parse()
            if self.peek() != CLOSE:
                raise ParseError("Unexpected token_type, expected ')'")
            self.next_token()
            return self.parse_sub_expression(inner)
        raise ParseError(f"Unexpected token_type, got {tok.type!r}")


def parse_with_opt(text: str, options: Options) -> UserAST:
    return _Parser(text, options)._parse()
