"""Compiled-pattern serialization and the on-disk compile cache
(`Config.disk_cache`; SURVEY.md §5.4).

rejit keeps generated code inside a `Regej` for reuse; the tables here are
plain numpy arrays, so a compiled pattern is an .npz file, keyed by a
content hash of (pattern list, compiler limits, format version). The file
format, FORMAT_VERSION, the key and the directory (REJIT_TPU_CACHE_DIR,
else ~/.cache/rejit_tpu) are the JAX package's, so a file either package
stored serves the other: both compile with the same compiler.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional, Sequence

import numpy as np

from ..compile.dfa import DFATables

FORMAT_VERSION = 1


def save_tables(path: str, t: DFATables) -> None:
    np.savez_compressed(
        path,
        format_version=np.int64(FORMAT_VERSION),
        class_of=t.class_of,
        next=t.next,
        accept=t.accept,
        accept_eot=t.accept_eot,
        start_states=t.start_states,
        dead=np.int64(t.dead),
        n_patterns=np.int64(t.n_patterns),
    )


def load_tables(path: str) -> DFATables:
    with np.load(path) as z:
        if int(z["format_version"]) != FORMAT_VERSION:
            raise ValueError(f"{path}: format {int(z['format_version'])}, "
                             f"not {FORMAT_VERSION}")
        return DFATables(
            class_of=z["class_of"],
            next=z["next"],
            accept=z["accept"],
            accept_eot=z["accept_eot"],
            start_states=z["start_states"],
            dead=int(z["dead"]),
            n_patterns=int(z["n_patterns"]),
        )


def cache_key(patterns: Sequence[bytes], max_nfa: int, max_dfa: int) -> str:
    h = hashlib.sha256()
    h.update(f"v{FORMAT_VERSION};{max_nfa};{max_dfa};".encode())
    for p in patterns:
        h.update(len(p).to_bytes(4, "little"))
        h.update(p)
    return h.hexdigest()[:32]


def default_cache_dir() -> str:
    return os.environ.get(
        "REJIT_TPU_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "rejit_tpu"),
    )


def load_cached(
    patterns: Sequence[bytes], max_nfa: int, max_dfa: int
) -> Optional[DFATables]:
    path = os.path.join(
        default_cache_dir(), cache_key(patterns, max_nfa, max_dfa) + ".npz"
    )
    if not os.path.exists(path):
        return None
    try:
        return load_tables(path)
    except Exception:
        return None


def store_cached(
    patterns: Sequence[bytes], max_nfa: int, max_dfa: int, t: DFATables
) -> None:
    d = default_cache_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, cache_key(patterns, max_nfa, max_dfa) + ".npz")
    tmp = path + ".tmp.npz"  # ends in .npz so np.savez won't append
    try:
        save_tables(tmp, t)
        os.replace(tmp, path)
    except OSError:
        pass
