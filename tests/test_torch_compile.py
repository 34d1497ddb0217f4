"""The port's copy of the compiler gives the JAX package's tables and
analysis, array for array."""
import dataclasses
import json
import os

import numpy as np
import pytest

from rejit_tpu.compile import analysis as jax_analysis
from rejit_tpu.compile import dfa as jax_dfa
from rejit_tpu.compile import parser as jax_parser
from rejit_tpu_torch.compile import analysis, dfa, parser

_HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(_HERE, "conformance", "corpus.json")) as f:
    _CASES = json.load(f)

PATS = [rb"\w+ing\b", rb"[a-z]+", rb"foo|bar", rb"a*", rb"^line"]
TOKENIZER = (rb"\w+", rb"\s+", rb"[^\w\s]+")


def _pattern_sets():
    sets = [(p,) for p in PATS] + [(rb"\b\w+ing\b",), TOKENIZER]
    for case in _CASES:
        s = tuple(p.encode("latin-1") for p in case["patterns"])
        if s not in sets:
            sets.append(s)
    return sets


SETS = _pattern_sets()


def _id(s):
    return "|".join(p.decode("latin-1") for p in s)


@pytest.mark.parametrize("pats", SETS, ids=[_id(s) for s in SETS])
def test_tables_and_analysis_equal(pats):
    mine_irs = [parser.parse(p) for p in pats]
    ref_irs = [jax_parser.parse(p) for p in pats]
    mine = dfa.compile_patterns(mine_irs)
    ref = jax_dfa.compile_patterns(ref_irs)
    for field in ("class_of", "next", "accept", "accept_eot", "start_states"):
        a, b = getattr(mine, field), getattr(ref, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert mine.dead == ref.dead
    assert mine.n_patterns == ref.n_patterns
    assert dataclasses.asdict(analysis.analyze(mine_irs)) == dataclasses.asdict(
        jax_analysis.analyze(ref_irs)
    )
