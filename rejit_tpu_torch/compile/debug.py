"""Debug pretty-printers for compiled artifacts (`Config.print_tables`),
the same text as the JAX package's.

The analog of rejit's --print_re_tree / --print_re_list debug flags
(SURVEY.md §5.1). IR printing (`Config.print_tree`) lives in
compile/ir.py:format_tree.
"""
from __future__ import annotations

import numpy as np

from .dfa import DFATables


def _class_members(t: DFATables, c: int, limit: int = 8) -> str:
    members = np.flatnonzero(t.class_of == c)
    shown = ",".join(
        chr(b) if 0x21 <= b <= 0x7E else f"\\x{b:02x}" for b in members[:limit]
    )
    more = f"+{len(members) - limit}" if len(members) > limit else ""
    return f"{{{shown}{more}}}"


def format_tables(t: DFATables) -> str:
    lines = [
        f"DFA: {t.n_states} states x {t.n_classes} byte classes, "
        f"{t.n_patterns} pattern(s), dead={t.dead}, "
        f"starts(BEGIN,NL,WORD,OTHER)={t.start_states.tolist()}",
        "classes: "
        + " ".join(f"c{c}={_class_members(t, c)}" for c in range(t.n_classes)),
    ]
    for q in range(t.n_states):
        row = " ".join(
            f"c{c}->{t.next[q, c]}"
            + (f"/acc{t.accept[q, c]}" if t.accept[q, c] >= 0 else "")
            for c in range(t.n_classes)
        )
        eot = f" eot/acc{t.accept_eot[q]}" if t.accept_eot[q] >= 0 else ""
        lines.append(f"q{q}: {row}{eot}")
    return "\n".join(lines)


def format_nfa(nfa) -> str:
    lines = [f"NFA: {nfa.n_states} states, start={nfa.start}, accepts={nfa.accepts}"]
    for s in range(nfa.n_states):
        eps = " ".join(
            f"-eps{'' if k is None else f'[{k}]'}->{t}" for k, t in nfa.eps[s]
        )
        byte = " ".join(f"-byte->{t}" for _bm, t in nfa.byte_edges[s])
        if eps or byte:
            lines.append(f"s{s}: {eps} {byte}".rstrip())
    return "\n".join(lines)
