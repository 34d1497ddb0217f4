r"""Class-run + literal-suffix engine: \b?[class]{lo,hi}LIT\b?.

The port of rejit_tpu/kernels/classlit.py in torch ops. The match is
decomposed elementwise, independently of the DFA's state count:

  L[s] = max{ p : occ(p), s+lo <= p <= min(s+hi, e(s)) } + |S|

with occ(p) = "the literal S occurs at p" (|S| shifted compares) and e(s)
= the first non-class position at/after s. The windowed max collapses to
cumulative scans because the occurrence values are position-monotone:

  * F = cummax(occ positions): F[x] = last occurrence <= x, and since F is
    non-decreasing, F[min(a,b)] = min(F[a], F[b]);
  * R = reverse cummin of F masked to non-class positions: R[p] = F[e(p)];
  * so best[s] = min(F[s+hi], R[s]) (= F[min(s+hi, e)]), taken when
    >= s+lo.

Both scans are the scan1d kernel on the card (kernels/scan_cuda.py).

Optional \b's stay elementwise: a leading \b needs the class all word
bytes and lo >= 1 (then: previous byte non-word / BOT); a trailing \b
compares the word-ness of the byte after the literal against S's last
byte.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import scan_cuda
from .classrun import BIG, finish, member, prev_word, rcummin


def detect(node) -> Optional[tuple]:
    """If the pattern is `\\b?[class]{lo,hi}LIT\\b?`, return
    (bitmap, lo, hi, suffix_bytes, lead_wb, trail_wb)."""
    from ..compile.analysis import classlit_of

    return classlit_of(node)


def shl(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x shifted left by d (element p reads x[p+d]), filled at the end."""
    if d == 0:
        return x
    d = min(d, x.shape[0])
    pad = torch.full((d,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[d:], pad])


def classlit_l_arrays_device(
    lut: torch.Tensor,
    wlut: torch.Tensor,
    text: torch.Tensor,
    n: int,
    *,
    lo: int,
    hi: Optional[int],
    sfx: Tuple[int, ...],
    lead_wb: bool = False,
    trail_wb: bool = False,
    use_kernel: bool = False,
    class_runs=None,
    word_runs=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, I) int32 of length P+1 for a class-run + literal-suffix pattern
    over a padded uint8 text of P >= n bytes (hi None = unbounded)."""
    P = text.shape[0]
    m = len(sfx)
    pos = torch.arange(P, dtype=torch.int32, device=text.device)
    inc = member(text, class_runs, lut)
    inc[n:] = False

    # occ[p]: S at p (within n), plus the trailing-\b condition.
    occ = text == sfx[0]
    for j in range(1, m):
        occ &= shl(text, j, 0) == sfx[j]
    occ[max(0, n - m + 1):] = False
    if trail_wb:
        # \b after the literal: word-ness flips at p+m (EOT is non-word).
        from ..compile.ir import WORD

        after_w = shl(member(text, word_runs, wlut), m, False)
        after_w[max(0, n - m):] = False
        occ &= after_w != bool((WORD >> sfx[-1]) & 1)
    val = torch.where(occ, pos, -1)

    cummax = scan_cuda.cummax if use_kernel else scan_cuda.cummax_plain
    F = cummax(val)
    R = rcummin(torch.where(inc, BIG, F), use_kernel)
    F_last = F[-1]
    if hi is not None:
        # F[s+hi] with everything past the array covered by F_last.
        h = min(hi, P)
        f2 = torch.cat([F[h:], F_last.expand(h)]) if hi else F
        cand = torch.minimum(f2, R)         # F[min(s+hi, e)]; R == BIG: +inf
    else:
        cand = torch.where(R >= BIG, F_last, R)     # cap is e (or EOT)
    best = torch.where(cand >= pos + lo, cand, -1)

    L = torch.where(best >= 0, best + m, -1)
    if lead_wb:
        # class is all word bytes and lo >= 1 (detect() guarantees), so the
        # leading \b is: previous byte non-word, or s == 0.
        L.masked_fill_(prev_word(text, word_runs, wlut), -1)
    return finish(L)
