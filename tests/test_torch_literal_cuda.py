"""The literal_count kernel (kernels/csrc/literal_count.cu) on the card
against its plain version, bit for bit: on chip_smoke's literal sets and
text (1 to 15 literals of 1 to 128 bytes: one, two and four state words, and
several launches a set), a class literal and a literal longer than the
state, at n = P, P - 3, a segment edge, 1, 0, negative and past P; on the
literal cell's corpus (portbench's generator) at 256 MiB, through a staged
corpus's padded text, an unaligned view of it and a mesh-style shard whose n
lies past its P; and the API's launch count on a staged corpus.

Every test needs a CUDA card and skips without one (the kernel has no CPU
form; its algorithm is held against rejit_tpu on the CPU by
tests/test_torch_literal.py's numpy model). This file imports no JAX, so it
also runs on the card's machine, where the repo's conftest (which imports
JAX) is skipped: python -m pytest --noconftest -o addopts="" -m cuda
tests/test_torch_literal_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
import rejit_tpu_torch as rt
from portbench.corpus import words
from rejit_tpu_torch.kernels import literal as lk

CELL_SIZE = 256 << 20


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the literal_count kernel has no "
                    "CPU form)")
    return torch.device("cuda")


def _equal(ext, n, lits, P) -> bool:
    got = lk.literal_count_device(ext, n, lits=lits, P=P)
    want = lk.literal_count_plain(ext, n, lits=lits, P=P)
    return int(got) == int(want)


@pytest.mark.cuda
def test_kernel_equals_plain_on_smoke_sets(card):
    e = chip_smoke.literal_count_vs_plain(rt, lk, np.random.default_rng(5))
    assert e["max_abs_err"] == 0, e
    assert e["words"] == [1, 2, 4] and e["max_count"] > 0, e


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_cell_corpus(card):
    lits = rt.Pattern("foo|bar|baz", device="cpu").info.literals
    corpus = rt.stage(words.make(CELL_SIZE, 3100000001, card, "foo", 0.001)
                      .cpu().numpy(), card)
    ext, P_arr = corpus.padded_ext(3)
    P = P_arr - 3
    n = corpus.n
    assert _equal(ext, n, lits, P)
    # An unaligned view of the staged text, and a mesh-style shard: P = S
    # positions, its next shard's first bytes as halo, n past S.
    assert _equal(ext[7:], n - 7, lits, P - 7)
    S = (CELL_SIZE // 8) + 13
    shard = ext[3 * S:4 * S + 2]
    assert _equal(shard, n - 3 * S, lits, S)
    assert int(lk.literal_count_device(ext, n, lits=lits, P=P)) > 0


@pytest.mark.cuda
def test_api_launches_the_kernel_once_a_count(card):
    corpus = rt.stage(words.make(1 << 22, 7, card, "foo", 0.001).cpu()
                      .numpy(), card)
    p = rt.Pattern("foo|bar|baz", device=card)
    want = p.match_all_count(corpus.host.tobytes())
    lk.reset_launches()
    assert p.match_all_count(corpus) == want
    assert lk.LAUNCHES == {"literal_count": 1}
    for pat in ("[a-z]+", [r"\w+", r"\s+", r"[^\w\s]+"]):
        lk.reset_launches()
        rt.Pattern(pat, device=card).match_all_count(corpus)
        assert lk.LAUNCHES == {"literal_count": 0}, pat
