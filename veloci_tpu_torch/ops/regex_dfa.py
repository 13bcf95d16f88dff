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
``[S, S]`` matmuls. :func:`regex_match_pair` walks two matrices (a field's
sweep rows and its long rows) in one launch, into one output. On a CUDA
tensor each launches the hand-written kernel ``csrc/regex_dfa.cu`` (one
thread a row, a row's chars loaded ahead of its walk, one shared-memory
read a step from the folded tables of :func:`build_walk_argument`, built
once a ``CompiledDfa``); on a CPU tensor each takes its plain version,
:func:`regex_match_plain` or :func:`regex_match_pair_plain`, the same walk
in PyTorch. :func:`cached_dfa` compiles a pattern and builds its argument
once for all the leaves and requests that send it. Each wrapper counts its launches in ``.launches``.

Semantics of the walk, shared by both: a char's class is the number of
boundaries ``<=`` it (a code point above 0xFFFF, or a negative pad code,
reads as U+FFFD, as the sweep matrix stores it); state 0 is the start; a
row takes ``min(length, W)`` steps; a full match ends in an accepting
state; a prefix match (``starts_with``, ``re.match``) accepts after any
step, or at the start when state 0 accepts; rows of length 0 never match.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["compile_dfa", "CompiledDfa", "build_walk_argument", "cached_dfa", "regex_match", "regex_match_pair",
           "regex_match_pair_plain", "regex_match_plain", "walk_argument"]

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
# matrix a and matrix b, each (chars, element bytes, stride between
# positions, stride between rows, width, lengths, n); the host WALK_ARG
# buffer, prefix, out, stream
_ROWS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int]
SIGNATURE = {
    "veloci_regex_walk": [*_ROWS, *_ROWS, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
}

DFA_CACHE_SIZE = 512  # patterns kept by cached_dfa
ACCEPTS = 0x40  # a transition entry's bit: the next state accepts
DEAD = 0x80  # a transition entry's bit: the next state is the dead state
# The kernel's DFA argument (``csrc/regex_dfa.cu``'s ``WalkDfa``, byte for
# byte): the transitions ``[C, S]`` folded with the next state's bits, each
# ASCII char's class times S, and the boundaries in (127, 0xFFFF] for the
# others.
WALK_ARG = np.dtype([
    ("next", np.uint8, (MAX_CLASSES * MAX_STATES,)),
    ("ascii", np.uint16, (128,)),
    ("high", np.uint32, (32,)),
    ("nhigh", np.int32),
    ("high_class", np.int32),
    ("states", np.int32),
    ("start_accepts", np.int32),
    ("used", np.int32),
], align=True)


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


def regex_match_pair_plain(a_chars_t, a_lengths, b_chars_t, b_lengths, dfa: CompiledDfa,
                           prefix: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`regex_match_pair`: the two walks of
    :func:`regex_match_plain`, concatenated."""
    return torch.cat([regex_match_plain(a_chars_t, a_lengths, dfa, prefix),
                      regex_match_plain(b_chars_t, b_lengths, dfa, prefix)])


def build_walk_argument(dfa: CompiledDfa) -> np.ndarray:
    """The kernel's DFA argument, a 0-d :data:`WALK_ARG` array. A char's
    class folds into a table offset, ``class * S``: for a code point below
    128 it is ``ascii[c]``; for any other (above 0xFFFF read as U+FFFD) it
    is ``(high_class + the count of high boundaries <= c) * S``, ``high``
    holding the boundaries in ``(127, 0xFFFF]`` (one at 0x10000, which
    ``.`` and negated classes give, no code point reaches). The step from
    state ``s`` on a char of offset ``o`` is ``next[o + s]``: the next state
    in the low six bits, with :data:`ACCEPTS` when it accepts and
    :data:`DEAD` when it is the dead state."""
    c, s = dfa.trans.shape
    bounds = np.asarray(dfa.boundaries, dtype=np.int64)
    trans = np.asarray(dfa.trans, dtype=np.int64)
    bits = np.where(np.asarray(dfa.accept, dtype=bool), ACCEPTS, 0)
    if dfa.dead >= 0:
        bits[dfa.dead] |= DEAD
    arg = np.zeros((), WALK_ARG)
    arg["next"][: c * s] = (trans | bits[trans]).ravel()
    arg["ascii"] = np.searchsorted(bounds, np.arange(128), side="right") * s
    high = bounds[(bounds > 127) & (bounds <= _MAX_CP)]  # a code point never passes 0x10000
    arg["high"][: len(high)] = high
    arg["nhigh"], arg["high_class"], arg["states"] = len(high), int((bounds <= 127).sum()), s
    arg["start_accepts"], arg["used"] = bool(dfa.accept[0]), c * s
    return arg


def walk_argument(dfa: CompiledDfa) -> np.ndarray:
    """``dfa``'s kernel argument (:func:`build_walk_argument`), built at the
    first walk of this ``CompiledDfa`` and kept on it. A caller holds the
    array while the kernel reads its address."""
    arg = getattr(dfa, "walk_arg", None)
    if arg is None:
        arg = dfa.walk_arg = build_walk_argument(dfa)
    return arg


@functools.lru_cache(maxsize=DFA_CACHE_SIZE)
def cached_dfa(pattern: str, ignore_case: bool) -> Optional[CompiledDfa]:
    """:func:`compile_dfa` with its kernel argument built, kept for the last
    ``DFA_CACHE_SIZE`` ``(pattern, ignore_case)`` pairs: a regex leaf's
    pattern compiles once for every field it expands over and for every
    later request that sends it again. The DFA is shared: nothing changes
    it after this."""
    dfa = compile_dfa(pattern, ignore_case=ignore_case)
    if dfa is not None:
        walk_argument(dfa)
    return dfa


def _rows(chars_t, lengths):
    return (chars_t.data_ptr(), chars_t.element_size(), chars_t.stride(0), chars_t.stride(1), chars_t.shape[0],
            lengths.data_ptr(), lengths.shape[0])


_NO_ROWS = (0, 2, 0, 0, 0, 0, 0)


def _walk(a, b, dfa, prefix) -> torch.Tensor:
    """One launch of ``csrc/regex_dfa.cu`` over matrix ``a`` and, unless
    ``b`` is None, matrix ``b`` (each ``(chars_t, lengths)``, on one CUDA
    device), into one ``[N_a + N_b]`` bool tensor; no launch when that is
    empty."""
    dev = a[0].device
    out = torch.empty(a[1].shape[0] + (0 if b is None else b[1].shape[0]), dtype=torch.bool, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load(SOURCE, SIGNATURE)
    arg = walk_argument(dfa)

    def launch():
        return lib.veloci_regex_walk(
            *_rows(*a), *(_NO_ROWS if b is None else _rows(*b)), arg.ctypes.data, int(bool(prefix)),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )

    if dev.index is None or dev.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(dev):
            err = launch()
    if err != 0:
        msg = lib.veloci_cuda_error_string(err).decode()
        raise RuntimeError(f"veloci_regex_walk kernel launch failed: {msg} ({err})")
    return out


def _on_card(chars_t) -> bool:
    dev = chars_t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no regex walk for device {dev}")
    return dev.type == "cuda"


def regex_match(chars_t, lengths, dfa: CompiledDfa, prefix: bool = False) -> torch.Tensor:
    """``chars_t [W, N]`` uint16 or int32, any strides (a field's
    ``chars_t``, or ``LongTerms.codes.T``), ``lengths [N] int32`` ->
    ``[N] bool``: the rows the DFA accepts, a full match or, with
    ``prefix``, a prefix match (see the module's note).

    One launch of ``csrc/regex_dfa.cu`` for a CUDA tensor (the DFA's tables
    travel as a kernel argument built once a ``CompiledDfa``: no copy);
    :func:`regex_match_plain` for a CPU tensor."""
    _check(chars_t, lengths, dfa)
    if not _on_card(chars_t):
        return regex_match_plain(chars_t, lengths, dfa, prefix)
    out = _walk((chars_t, lengths), None, dfa, prefix)
    if out.numel():
        regex_match.launches += 1
    return out


regex_match.launches = 0


def regex_match_pair(a_chars_t, a_lengths, b_chars_t, b_lengths, dfa: CompiledDfa,
                     prefix: bool = False) -> torch.Tensor:
    """:func:`regex_match` over two matrices on one device (a field's sweep
    rows and its long rows' ``codes.T``) -> ``[N_a + N_b] bool``, the rows of
    ``a`` then those of ``b``: one launch for both on a CUDA tensor, none
    when both are empty; :func:`regex_match_pair_plain` on the CPU."""
    _check(a_chars_t, a_lengths, dfa)
    _check(b_chars_t, b_lengths, dfa)
    if b_chars_t.device != a_chars_t.device:
        raise ValueError(f"the two matrices are on {a_chars_t.device} and {b_chars_t.device}")
    if not _on_card(a_chars_t):
        return regex_match_pair_plain(a_chars_t, a_lengths, b_chars_t, b_lengths, dfa, prefix)
    out = _walk((a_chars_t, a_lengths), (b_chars_t, b_lengths), dfa, prefix)
    if out.numel():
        regex_match_pair.launches += 1
    return out


regex_match_pair.launches = 0
