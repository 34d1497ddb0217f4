r"""Class-run engine: patterns of the form \b?[class]{lo,hi}\b? (incl. +).

The port of rejit_tpu/kernels/classrun.py in torch ops. Maximal runs of a
byte class are found with a membership test and one reverse cumulative min
(the next non-member index), the scan1d kernel on the card
(kernels/scan_cuda.py): a few elementwise passes per byte, no DFA.

Exact leftmost-longest semantics: for boundary s inside a run ending at e,
L[s] = min(s + hi, e) provided the run from s has at least `lo` bytes.

Word-boundary-wrapped runs (class all word bytes) stay elementwise: the
leading \b is "previous byte non-word", the trailing \b pins the end to the
maximal-run end e with text[e] non-word (the low bit of the reverse-cummin
word). These are the bounded-quantifier patterns whose DFAs have Q ~ hi+2
states; here the cost does not depend on Q.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import scan_cuda

BIG = 2**30


def detect(node) -> Optional[Tuple[int, int, Optional[int], bool, bool]]:
    r"""If the pattern is `\b?[class]{lo,hi}\b?` with lo >= 1 (class all
    word bytes when a \b is present), return (bitmap, lo, hi, lead_wb,
    trail_wb). CharClass alone counts as {1,1}."""
    from ..compile.analysis import bclassrun_of

    return bclassrun_of(node)


def member_lut(bitmap: int) -> np.ndarray:
    lut = np.zeros(256, dtype=np.int32)
    for b in range(256):
        lut[b] = (bitmap >> b) & 1
    return lut


MAX_RUNS = 8  # membership via range compares up to this many runs


def bitmap_runs(bitmap: int) -> Optional[Tuple[Tuple[int, int], ...]]:
    """Contiguous byte ranges of a 256-bit class bitmap, or None when there
    are more than MAX_RUNS (then the 256-entry LUT gather is used)."""
    runs = []
    b = 0
    while b < 256:
        if (bitmap >> b) & 1:
            lo = b
            while b < 256 and (bitmap >> b) & 1:
                b += 1
            runs.append((lo, b - 1))
            if len(runs) > MAX_RUNS:
                return None
        else:
            b += 1
    return tuple(runs)


def member(text: torch.Tensor, runs, lut: torch.Tensor) -> torch.Tensor:
    """Class membership of each uint8 byte: range compares when `runs` is
    given, else the LUT gather."""
    if runs is None:
        return lut.index_select(0, text.to(torch.int32)) > 0
    m = torch.zeros(text.shape, dtype=torch.bool, device=text.device)
    for lo, hi in runs:
        m |= (text == lo) if lo == hi else ((text >= lo) & (text <= hi))
    return m


def rcummin(x: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """Reverse cummin: the scan1d wrapper (the kernel on the card), or the
    plain torch version on either device."""
    return scan_cuda.rcummin(x) if use_kernel else scan_cuda.rcummin_plain(x)


def prev_word(text: torch.Tensor, word_runs, wlut) -> torch.Tensor:
    """Whether the byte before each position is a word byte (False at 0)."""
    w = member(text, word_runs, wlut)
    return torch.cat([torch.zeros(1, dtype=torch.bool, device=w.device),
                      w[:-1]])


def finish(L: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, I) of length P+1: pattern id 0 where L >= 0, and boundary P with
    no match."""
    I = torch.where(L >= 0, 0, -1).to(torch.int32)
    tail = torch.full((1,), -1, dtype=torch.int32, device=L.device)
    return torch.cat([L, tail]), torch.cat([I, tail])


def classrun_l_arrays_device(
    lut: torch.Tensor,
    wlut: torch.Tensor,
    text: torch.Tensor,
    n: int,
    *,
    lo: int,
    hi: Optional[int],
    lead_wb: bool = False,
    trail_wb: bool = False,
    use_kernel: bool = False,
    class_runs=None,
    word_runs=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""(L, I) int32 of length P+1 for a `\b?[class]{lo,hi}\b?` run pattern
    over a padded uint8 text of P >= n bytes (hi None = unbounded).

    With a \b present the class is all word bytes (detect() guarantees),
    so the boundary tests are elementwise:
      * leading \b: previous byte non-word, or s == 0;
      * trailing \b: the only viable match end is the maximal-run end e,
        and it matches iff text[e] is non-word or e == n. The stop byte's
        word-ness rides in the low bit of the reverse-cummin word.
    """
    P = text.shape[0]
    pos = torch.arange(P, dtype=torch.int32, device=text.device)
    inc = member(text, class_runs, lut)
    inc[n:] = False
    if trail_wb:
        # stop position acceptable <=> non-word byte there, or at/past n
        stop_bad = member(text, word_runs, wlut)
        stop_bad[n:] = False
        nm = torch.where(inc, BIG, (pos << 1) | stop_bad.to(torch.int32))
        ne = rcummin(nm, use_kernel)
        # A run reaching the padded array end stops at n (EOT: \b holds).
        over = ne >= BIG
        run_end = torch.where(over, n, ne >> 1).clamp_(max=n)
        t_ok = over | ((ne & 1) == 0)
        jlen = run_end - pos
        ok = inc & t_ok & (jlen >= lo)
        if hi is not None:
            ok &= jlen <= hi
        L = torch.where(ok, run_end, -1)
    else:
        # Next non-member boundary at/after each position (reverse cummin).
        ne = rcummin(torch.where(inc, BIG, pos), use_kernel)
        run_end = ne.clamp_(max=n)                  # run from s ends here
        end = run_end if hi is None else torch.minimum(pos + hi, run_end)
        L = torch.where(inc & (run_end - pos >= lo), end, -1)
    if lead_wb:
        # inc[s] implies text[s] is a word byte; \b needs prev non-word.
        L.masked_fill_(prev_word(text, word_runs, wlut), -1)
    return finish(L)
