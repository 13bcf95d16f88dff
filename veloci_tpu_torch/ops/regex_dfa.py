"""Regex term matching: the host regex -> DFA compiler and a DFA walk over a
field's sweep rows, kernel B8.

:func:`compile_dfa` and what it uses (``CompiledDfa``, ``_parse``,
``_build_nfa``, ``_complement``, ``_casefold_ranges``) are a verbatim copy
of ``veloci_tpu/ops/regex_dfa.py:34-333``: the pattern (a practical regex
subset) compiles on the host to a DFA over character equivalence classes,
or to None for syntax it does not take (backrefs, lookaround, ``{m,n}``,
anchors, DFAs past ``MAX_STATES`` states or ``MAX_CLASSES`` classes).

:func:`regex_match` runs the DFA over the rows of a ``[W, N]`` char matrix
(a field's ``FieldSweep.chars_t``, or ``LongTerms.codes`` transposed): the
counterpart of ``regex_match_device`` (``:384``), whose XLA-built
``_sweep_kernel`` (``:339``) advances every term's state by one-hot
``[S, S]`` matmuls. On a CUDA tensor it launches the hand-written kernel
``csrc/regex_dfa.cu`` (one thread a row, a table walk with the DFA staged
in shared memory); on a CPU tensor it takes :func:`regex_match_plain`, the
same walk in PyTorch. The wrapper counts its launches in ``.launches``.

Semantics of the walk, shared by both: a char's class is the number of
boundaries ``<=`` it (a code point above 0xFFFF, or a negative pad code,
reads as U+FFFD, as the sweep matrix stores it); state 0 is the start; a
row takes ``min(length, W)`` steps; a full match ends in an accepting
state; a prefix match (``starts_with``, ``re.match``) accepts after any
step, or at the start when state 0 accepts; rows of length 0 never match.
"""

from __future__ import annotations

import ctypes
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["compile_dfa", "CompiledDfa", "regex_match", "regex_match_plain"]

MAX_STATES = 64
MAX_CLASSES = 30
_MAX_CP = 0xFFFF  # the char matrix stores uint16 code units

class CompiledDfa:
    def __init__(self, boundaries, trans, accept, dead):
        self.boundaries = boundaries  # u32 [C-1] class = searchsorted-style
        self.trans = trans  # i32 [C, S]
        self.accept = accept  # bool [S]
        self.dead = dead  # int: the absorbing reject state


# ----------------------------------------------------------------- parser
# regex subset -> NFA (Thompson). Node = (op, args)


class _ParseError(Exception):
    pass


_CLASS_SHORTHANDS = {
    "d": [(ord("0"), ord("9"))],
    "w": [(ord("a"), ord("z")), (ord("A"), ord("Z")), (ord("0"), ord("9")),
          (ord("_"), ord("_"))],
    "s": [(9, 13), (32, 32)],
}


def _parse(pattern: str):
    pos = 0

    def peek():
        return pattern[pos] if pos < len(pattern) else None

    def take():
        nonlocal pos
        c = pattern[pos]
        pos += 1
        return c

    def parse_alt():
        branches = [parse_concat()]
        while peek() == "|":
            take()
            branches.append(parse_concat())
        return ("alt", branches) if len(branches) > 1 else branches[0]

    def parse_concat():
        items = []
        while peek() not in (None, "|", ")"):
            items.append(parse_repeat())
        if not items:
            return ("empty",)
        return ("cat", items) if len(items) > 1 else items[0]

    def parse_repeat():
        atom = parse_atom()
        while peek() in ("*", "+", "?"):
            op = take()
            if op == "*":
                atom = ("star", atom)
            elif op == "+":
                atom = ("cat", [atom, ("star", atom)])
            else:
                atom = ("alt", [atom, ("empty",)])
        if peek() == "{":
            raise _ParseError("{m,n} not supported")
        return atom

    def parse_atom():
        c = peek()
        if c is None:
            raise _ParseError("unexpected end")
        if c == "(":
            take()
            if peek() == "?":  # (?:...) group or any (?...) extension
                take()
                if peek() == ":":
                    take()
                else:
                    raise _ParseError("(?...) extensions not supported")
            inner = parse_alt()
            if peek() != ")":
                raise _ParseError("unbalanced paren")
            take()
            return inner
        if c == ")":
            raise _ParseError("unbalanced paren")
        if c == "[":
            return parse_class()
        if c == ".":
            take()
            return ("ranges", [(0, _MAX_CP)])
        if c == "\\":
            take()
            e = take()
            if e in _CLASS_SHORTHANDS:
                return ("ranges", list(_CLASS_SHORTHANDS[e]))
            if e in ("D", "W", "S"):
                return ("ranges", _complement(_CLASS_SHORTHANDS[e.lower()]))
            if e == "b":
                raise _ParseError("\\b not supported")
            return ("ranges", [(ord(e), ord(e))])
        if c in ("^", "$"):
            raise _ParseError("anchors not supported (matching is anchored)")
        take()
        return ("ranges", [(ord(c), ord(c))])

    def parse_class():
        take()  # [
        neg = False
        if peek() == "^":
            take()
            neg = True
        ranges: List[Tuple[int, int]] = []
        first = True
        while True:
            c = peek()
            if c is None:
                raise _ParseError("unterminated class")
            if c == "]" and not first:
                take()
                break
            first = False
            if c == "\\":
                take()
                e = take()
                if e in _CLASS_SHORTHANDS:
                    ranges.extend(_CLASS_SHORTHANDS[e])
                    continue
                lo = ord(e)
            else:
                lo = ord(take())
            if peek() == "-" and pos + 1 < len(pattern) and pattern[pos + 1] != "]":
                take()
                hi_c = take()
                hi = ord(take()) if hi_c == "\\" else ord(hi_c)
                ranges.append((lo, hi))
            else:
                ranges.append((lo, lo))
        if neg:
            ranges = _complement(ranges)
        return ("ranges", ranges)

    ast = parse_alt()
    if pos != len(pattern):
        raise _ParseError("trailing input")
    return ast


def _complement(ranges):
    pts = sorted((lo, hi) for lo, hi in ranges)
    out = []
    cur = 0
    for lo, hi in pts:
        if lo > cur:
            out.append((cur, lo - 1))
        cur = max(cur, hi + 1)
    if cur <= _MAX_CP:
        out.append((cur, _MAX_CP))
    return out


def _casefold_ranges(ranges):
    out = list(ranges)
    for lo, hi in ranges:
        # ASCII case folding; non-ASCII folding handled per-char below cap
        a, b = max(lo, ord("a")), min(hi, ord("z"))
        if a <= b:
            out.append((a - 32, b - 32))
        a, b = max(lo, ord("A")), min(hi, ord("Z"))
        if a <= b:
            out.append((a + 32, b + 32))
    return out


# ---------------------------------------------------- NFA + subset construction


def _build_nfa(ast, ignore_case: bool):
    """Thompson construction: states with eps edges + ranged edges."""
    eps: List[List[int]] = []
    edges: List[List[Tuple[Tuple[int, int], int]]] = []

    def new_state():
        eps.append([])
        edges.append([])
        return len(eps) - 1

    def build(node, s_in):
        op = node[0]
        if op == "empty":
            return s_in
        if op == "ranges":
            ranges = node[1]
            if ignore_case:
                ranges = _casefold_ranges(ranges)
            s_out = new_state()
            for r in ranges:
                edges[s_in].append((r, s_out))
            return s_out
        if op == "cat":
            cur = s_in
            for child in node[1]:
                cur = build(child, cur)
            return cur
        if op == "alt":
            s_out = new_state()
            for child in node[1]:
                b_in = new_state()
                eps[s_in].append(b_in)
                b_out = build(child, b_in)
                eps[b_out].append(s_out)
            return s_out
        if op == "star":
            s_loop = new_state()
            s_out = new_state()
            eps[s_in].append(s_loop)
            eps[s_in].append(s_out)
            body_out = build(node[1], s_loop)
            eps[body_out].append(s_loop)
            eps[body_out].append(s_out)
            return s_out
        raise _ParseError(f"unknown node {op}")

    start = new_state()
    final = build(ast, start)
    return eps, edges, start, final


def compile_dfa(pattern: str, ignore_case: bool = False) -> Optional[CompiledDfa]:
    """Compile to a class-alphabet DFA; None when unsupported/too large."""
    try:
        ast = _parse(pattern)
        eps, edges, start, final = _build_nfa(ast, ignore_case)
    except _ParseError:
        return None

    # character equivalence classes from every edge's range endpoints
    bounds: Set[int] = set()
    for es in edges:
        for (lo, hi), _t in es:
            bounds.add(lo)
            bounds.add(hi + 1)
    boundaries = sorted(b for b in bounds if 0 < b <= _MAX_CP + 1)
    if len(boundaries) + 1 > MAX_CLASSES:
        return None
    nclasses = len(boundaries) + 1

    def class_of(cp: int) -> int:
        return int(np.searchsorted(boundaries, cp, side="right"))

    # representative char per class (for edge evaluation)
    reps = [0] + boundaries

    def eclose(states: FrozenSet[int]) -> FrozenSet[int]:
        stack = list(states)
        seen = set(states)
        while stack:
            s = stack.pop()
            for t in eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = eclose(frozenset([start]))
    dfa_index: Dict[FrozenSet[int], int] = {start_set: 0}
    dfa_states = [start_set]
    trans_rows: List[List[int]] = []
    i = 0
    while i < len(dfa_states):
        cur = dfa_states[i]
        row = []
        for c in range(nclasses):
            rep = reps[c]
            nxt = set()
            for s in cur:
                for (lo, hi), t in edges[s]:
                    if lo <= rep <= hi:
                        nxt.add(t)
            nset = eclose(frozenset(nxt)) if nxt else frozenset()
            j = dfa_index.get(nset)
            if j is None:
                j = len(dfa_states)
                if j >= MAX_STATES:
                    return None
                dfa_index[nset] = j
                dfa_states.append(nset)
            row.append(j)
        trans_rows.append(row)
        i += 1

    n_states = len(dfa_states)
    trans = np.zeros((nclasses, n_states), dtype=np.int32)
    for s, row in enumerate(trans_rows):
        for c, t in enumerate(row):
            trans[c, s] = t
    accept = np.array([final in st for st in dfa_states], dtype=bool)
    dead = dfa_index.get(frozenset(), -1)
    return CompiledDfa(
        np.asarray(boundaries, dtype=np.uint32), trans, accept, dead
    )



# ------------------------------------------------------------- the DFA walk

SOURCE = "regex_dfa.cu"
# (chars, element bytes, stride between positions, stride between rows,
# width, lengths, n, host boundaries, boundary count, host transitions,
# states, accept mask, dead state, prefix, out, stream)
SIGNATURE = {
    "veloci_regex_match": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p],
}


def _check(chars_t, lengths, dfa) -> None:
    if chars_t.dtype not in (torch.uint16, torch.int32) or chars_t.dim() != 2:
        raise ValueError(f"chars_t must be a 2-d uint16 or int32 tensor, got {chars_t.dim()}-d {chars_t.dtype}")
    if lengths.dtype != torch.int32 or lengths.dim() != 1 or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous 1-d torch.int32 tensor")
    if lengths.device != chars_t.device:
        raise ValueError(f"lengths is on {lengths.device}, chars_t on {chars_t.device}")
    if lengths.shape[0] != chars_t.shape[1]:
        raise ValueError("chars_t must be [W, N] with lengths [N]")
    c, s = dfa.trans.shape
    if not (1 <= c <= MAX_CLASSES and 1 <= s <= MAX_STATES and len(dfa.boundaries) == c - 1):
        raise ValueError(f"a DFA of {c} classes and {s} states is outside the walk's tables")


def _codes(col: torch.Tensor) -> torch.Tensor:
    """One position of the matrix as int64 code points: uint16 as unsigned,
    int32 as unsigned 32 bits, and anything above 0xFFFF as U+FFFD."""
    if col.dtype == torch.uint16:
        return col.view(torch.int16).to(torch.int64) & 0xFFFF
    c = col.to(torch.int64) & 0xFFFFFFFF
    return torch.where(c > 0xFFFF, 0xFFFD, c)


def regex_match_plain(chars_t, lengths, dfa: CompiledDfa, prefix: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`regex_match`, on any device: one step
    a position, vectorised over the rows (a ``searchsorted`` for the class,
    a gather for the next state)."""
    _check(chars_t, lengths, dfa)
    dev = chars_t.device
    w, n = chars_t.shape
    lens = lengths.to(torch.int64).clamp(max=w)
    bounds = torch.from_numpy(dfa.boundaries.astype(np.int64)).to(dev)
    trans = torch.from_numpy(dfa.trans.astype(np.int64)).to(dev)
    accept = torch.from_numpy(np.asarray(dfa.accept, dtype=bool)).to(dev)
    state = torch.zeros(n, dtype=torch.int64, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    for j in range(int(lens.max()) if n else 0):
        cls = torch.searchsorted(bounds, _codes(chars_t[j]), right=True)
        active = j < lens
        state = torch.where(active, trans[cls, state], state)
        if prefix:
            hit |= accept[state] & active
    matched = accept[state]
    if prefix:
        matched = matched | hit | accept[0]
    return matched & (lens > 0)


def _tables(dfa: CompiledDfa):
    """The kernel's host arguments: boundaries u32, the transition table u8
    ``[C, S]`` row-major, the accept set as a bit mask."""
    bounds = np.ascontiguousarray(dfa.boundaries, dtype=np.uint32)
    trans = np.ascontiguousarray(dfa.trans, dtype=np.uint8)
    mask = sum(1 << int(s) for s in np.flatnonzero(dfa.accept))
    return bounds, trans, mask


def regex_match(chars_t, lengths, dfa: CompiledDfa, prefix: bool = False) -> torch.Tensor:
    """``chars_t [W, N]`` uint16 or int32, any strides (a field's
    ``chars_t``, or ``LongTerms.codes.T``), ``lengths [N] int32`` ->
    ``[N] bool``: the rows the DFA accepts, a full match or, with
    ``prefix``, a prefix match (see the module's note).

    One launch of ``csrc/regex_dfa.cu`` for a CUDA tensor (the DFA's tables
    travel as kernel arguments: no copy); :func:`regex_match_plain` for a
    CPU tensor."""
    _check(chars_t, lengths, dfa)
    dev = chars_t.device
    if dev.type == "cpu":
        return regex_match_plain(chars_t, lengths, dfa, prefix)
    if dev.type != "cuda":
        raise ValueError(f"no regex walk for device {dev}")
    w, n = chars_t.shape
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    bounds, trans, mask = _tables(dfa)
    lib = _build.load(SOURCE, SIGNATURE)

    def launch():
        return lib.veloci_regex_match(
            chars_t.data_ptr(), chars_t.element_size(), chars_t.stride(0), chars_t.stride(1), w,
            lengths.data_ptr(), n, bounds.ctypes.data, len(bounds), trans.ctypes.data, trans.shape[1],
            mask, int(dfa.dead), int(bool(prefix)), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )

    if dev.index is None or dev.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(dev):
            err = launch()
    if err != 0:
        msg = lib.veloci_cuda_error_string(err).decode()
        raise RuntimeError(f"veloci_regex_match kernel launch failed: {msg} ({err})")
    regex_match.launches += 1
    return out


regex_match.launches = 0
