"""The corpus generator made on the device keeps make_corpus's shape: its
vocabulary, a uniform draw, the needle's word density, one space after
each word, the exact size; the same seed gives the same bytes."""
import numpy as np
import pytest
import torch

from portbench import run
from rejit_tpu_torch.utils.corpus import _WORDS, make_corpus

GEN = run.load_module(run.HERE / "corpus" / "words.py")
SIZE = 1 << 21


def _words(t: torch.Tensor):
    return bytes(t.numpy()).split()


def test_vocabulary_is_make_corpus_vocabulary():
    assert list(GEN.WORDS) == list(_WORDS)
    ws = _words(GEN.make(SIZE, 7, "cpu"))
    # every word but the last, which the size may cut, is a vocabulary word
    assert set(ws[:-1]) == set(_WORDS)


def test_size_seed_and_shape():
    a = GEN.make(SIZE, 2**31 + 99, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (SIZE,)
    assert torch.equal(a, GEN.make(SIZE, 2**31 + 99, "cpu"))
    assert not torch.equal(a, GEN.make(SIZE, 2**31 + 100, "cpu"))
    b = bytes(a.numpy())
    assert b"  " not in b and not b.startswith(b" ")
    # words a MiB and each word's share as make_corpus's (uniform draw)
    ref = make_corpus(SIZE, 3).split()
    ws = b.split()
    assert abs(len(ws) - len(ref)) < 0.01 * len(ref)
    counts = np.array([ws.count(w) for w in _WORDS])
    assert counts.min() > 0.85 * len(ws) / len(_WORDS)
    assert counts.max() < 1.15 * len(ws) / len(_WORDS)


def test_needle_density():
    ws = _words(GEN.make(1 << 23, 11, "cpu", needle="foo", density=0.001))
    share = ws.count(b"foo") / len(ws)
    # ~1.4M words: the share's standard error is ~2.7e-5
    assert abs(share - 0.001) < 1.5e-4
    ref = make_corpus(1 << 23, 11, b"foo", 0.001).split()
    assert abs(ref.count(b"foo") / len(ref) - share) < 2.5e-4


@pytest.mark.cuda
def test_on_the_card(card):
    a = GEN.make(SIZE, 2**31 + 5, card, needle="foo", density=0.001)
    assert a.device.type == "cuda" and a.shape == (SIZE,)
    assert torch.equal(a, GEN.make(SIZE, 2**31 + 5, card, needle="foo",
                                   density=0.001))
    assert set(_words(a.cpu())[:-1]) <= set(_WORDS) | {b"foo"}
