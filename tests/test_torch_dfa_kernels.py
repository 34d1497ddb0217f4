"""The port's DFA phases and pipeline == the JAX package's, exactly.

Same numpy inputs and identical tables (through device_tables_from_arrays)
go to both sides. The JAX side runs its Pallas kernels in interpret mode,
as its own tests do on the CPU, on the (K, nb) class and start-state views
of the text; the port runs its kernels' plain versions (CPU tensors) on the
text's bytes. Every value is an int32 position, state or id, so the
tolerance is exact equality. The JAX outputs are computed once per pattern
set and n, and shared by the cases that read them.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rejit_tpu.compile import parser as jax_parser
from rejit_tpu.compile.dfa import compile_patterns
from rejit_tpu.engine import pipeline as jpipe
from rejit_tpu.kernels import dfa_pallas
from rejit_tpu_torch.engine import pipeline
from rejit_tpu_torch.kernels import dfa_cuda

# Small inputs: one intra-op thread keeps the xdist workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

PATS = [
    (rb"\w+ing\b",), (rb"[a-z]+",), (rb"foo|bar",), (rb"a*",), (rb"^line",),
    (rb"\b\w+ing\b",), (rb"\w+", rb"\s+", rb"[^\w\s]+"),
]
IDS = ["|".join(p.decode() for p in s) for s in PATS]
K = 8
NB = dfa_pallas.CHUNK          # blocks of the dense text: one JAX grid step
LIVE_BLOCK = 5                 # a block of 'a's: every thread of some sets
                               # stays off the dead state to its end
# The sets whose threads all live through LIVE_BLOCK.
LIVE_SETS = [PATS[0], PATS[1], PATS[3], PATS[6]]


@functools.lru_cache(maxsize=None)
def _tables(pats):
    t = compile_patterns([jax_parser.parse(p) for p in pats])
    ct = pipeline.device_tables_from_arrays(
        t.class_of, t.next, t.accept, t.accept_eot, t.start_states, t.dead,
        t.n_patterns, device="cpu",
    )
    return t, jpipe.device_tables(t), ct


def _text(pats, nb, sparse=False):
    P = nb * K
    rng = np.random.default_rng(sum(map(len, pats)) * 7919 + nb)
    if sparse:
        text = rng.choice(np.frombuffer(b" .,;", np.uint8), size=P)
        for a in rng.choice(P - 8, size=P // 400, replace=False):
            text[a:a + 7] = np.frombuffer(b"singing", np.uint8)
        return text.astype(np.uint8)
    text = rng.choice(
        np.frombuffer(b"abfo liner\n singing!", np.uint8), size=P
    ).astype(np.uint8)
    text[LIVE_BLOCK * K:(LIVE_BLOCK + 1) * K] = ord("a")
    return text


def _jax_views(jct, text, posbase):
    """The JAX kernels' (K, nb) views of the blocks at `posbase`: row k
    holds the class of byte posbase + k (0 past the text) and the start
    state after the byte before it (the begin state at byte 0)."""
    class_of, ctx_of, sbc = (np.asarray(x) for x in (
        jct.class_of, jct.ctx_of, jct.start_by_ctx))
    ext = np.concatenate([text, np.zeros(K, np.uint8)])
    pos = posbase[None, :] + np.arange(K)[:, None]
    cls = class_of[ext[pos]]
    starts = np.where(pos == 0, sbc[0],
                      sbc[ctx_of[ext[np.maximum(pos - 1, 0)]]])
    return cls.astype(np.int32), starts.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ref(pats, n):
    """The dense text of `pats` and the JAX package's phase-1 summaries,
    suffix scan and phase-3 (L, I) on it at true length n."""
    _, jct, _ = _tables(pats)
    text = _text(pats, NB)
    cls_kb, startsb = _jax_views(jct, text, np.arange(NB) * K)
    summ = dfa_pallas.phase1_pallas(
        jct.packed, jct.n_classes, jnp.asarray(cls_kb), jnp.int32(n), K=K,
        interpret=True,
    )
    suf = jpipe.suffix_scan(summ, jpipe.eot_seed(jct, jnp.int32(n)))
    LI = dfa_pallas.phase3_pallas(
        jct.packed, jct.n_classes, suf, jnp.asarray(cls_kb),
        jnp.asarray(startsb), jnp.int32(n), K=K, interpret=True,
    )
    as_np = lambda xs: tuple(np.asarray(x) for x in xs)  # noqa: E731
    return text, as_np(summ), as_np(suf), as_np(LI)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32, order="C"))


def _eq(mine, ref):
    if isinstance(mine, tuple):
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            _eq(a, b)
        return
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


def _phases_equal_pallas(ct, pats, n):
    text, summ_ref, suf_ref, LI_ref = _ref(pats, n)
    tt = torch.from_numpy(text)
    summ = dfa_cuda.phase1(ct, tt, n, K)
    _eq(summ, summ_ref)
    suf = pipeline.suffix_scan(summ, pipeline.eot_seed(ct, n))
    _eq(suf, suf_ref)
    _eq(dfa_cuda.phase3(ct, suf, tt, n, K), LI_ref)


@pytest.mark.parametrize("pats", PATS, ids=IDS)
def test_phases_and_suffix_scan_equal_pallas(pats):
    _phases_equal_pallas(_tables(pats)[2], pats, NB * K - 3)


@pytest.mark.parametrize("pats", PATS, ids=IDS)
def test_phases_without_dead_state_equal_pallas(pats):
    """Tables that name no dead state: every thread runs to its block end,
    as the TPU kernels' do."""
    ct = _tables(pats)[2]
    assert ct.dead == 0
    _phases_equal_pallas(dataclasses.replace(ct, dead=-1), pats, NB * K - 3)


@pytest.mark.parametrize("pats", PATS, ids=IDS)
def test_phases_n_in_first_block_equal_pallas(pats):
    _phases_equal_pallas(_tables(pats)[2], pats, K - 3)


@pytest.mark.parametrize("pats", LIVE_SETS,
                         ids=[IDS[PATS.index(p)] for p in LIVE_SETS])
def test_block_where_no_thread_dies(pats):
    """In LIVE_BLOCK every phase-3 thread is off the dead state at the
    block end (so all K take the splice), and the port's (L, I) there
    equal the JAX kernel's."""
    t, _, ct = _tables(pats)
    n = NB * K - 3
    text, _, suf_ref, LI_ref = _ref(pats, n)
    ctx_of = t.ctx_table()
    for k in range(K):
        s = LIVE_BLOCK * K + k
        S = int(t.start_states[ctx_of[text[s - 1]]])
        for b in text[s:(LIVE_BLOCK + 1) * K]:
            S = int(t.next[S, t.class_of[b]])
        assert S != t.dead, k
    L, I = dfa_cuda.phase3(ct, tuple(_t(x) for x in suf_ref),
                           torch.from_numpy(text), n, K)
    blk = slice(LIVE_BLOCK * K, (LIVE_BLOCK + 1) * K)
    _eq((L[blk], I[blk]), tuple(x[blk] for x in LI_ref))


@pytest.mark.parametrize("pats", PATS[:2], ids=IDS[:2])
def test_phase3_posbase_equals_pallas(pats):
    """Gathered blocks (as the fast-forward route sends them, with repeats
    here), some at a base of n, whose bytes run past the text's end: the
    port reads the bytes at each base, JAX their views."""
    _, jct, ct = _tables(pats)
    n = NB * K - 3
    text, _, suf_ref, _ = _ref(pats, n)
    rng = np.random.default_rng(3)
    idx = np.sort(rng.choice(NB, size=NB, replace=True))
    posbase = (idx * K).astype(np.int32)
    posbase[rng.random(NB) < 0.1] = n
    suf_c = tuple(x[idx] for x in suf_ref)
    cls_c, starts_c = _jax_views(jct, text, posbase)
    L, I = dfa_cuda.phase3(ct, tuple(_t(x) for x in suf_c),
                           torch.from_numpy(text), n, K, posbase=_t(posbase))
    _eq((L, I), dfa_pallas.phase3_pallas(
        jct.packed, jct.n_classes, tuple(jnp.asarray(x) for x in suf_c),
        jnp.asarray(cls_c), jnp.asarray(starts_c), jnp.int32(n),
        posbase=jnp.asarray(posbase), K=K, interpret=True,
    ))


@pytest.mark.parametrize("pats", PATS, ids=IDS)
def test_l_arrays_device_equals_jax(pats):
    _, jct, ct = _tables(pats)
    n = NB * K - 3
    text = _text(pats, NB)
    mine = pipeline.l_arrays_device(ct, torch.from_numpy(text), n, block=K)
    _eq(mine, jpipe.l_arrays_device(jct, jnp.asarray(text), jnp.int32(n),
                                    block=K))
    if pats in PATS[:2]:
        _eq(mine, jpipe.l_arrays_device_pallas(
            jct, jnp.asarray(text), jnp.int32(n), block=K, interpret=True,
        ))


@pytest.mark.parametrize("pats", PATS, ids=IDS)
@pytest.mark.parametrize("force", [True, False], ids=["force", "auto"])
def test_l_arrays_device_ff_equals_jax(pats, force):
    _, jct, ct = _tables(pats)
    nb = 256
    text = _text(pats, nb, sparse=True)
    n = nb * K - 5
    mine = pipeline.l_arrays_device_ff(
        ct, torch.from_numpy(text), n, block=K, force=force
    )
    _eq(mine, jpipe.l_arrays_device_ff(
        jct, jnp.asarray(text), jnp.int32(n), block=K, force=force
    ))


def test_ff_route_gathers_sparse_blocks():
    """On the sparse text the auto route really takes the gathered path."""
    _, _, ct = _tables((rb"\b\w+ing\b",))
    nb = 256
    text = _text((rb"\b\w+ing\b",), nb, sparse=True)
    _, cand, c = pipeline.ff_phase12(ct, torch.from_numpy(text),
                                     nb * K - 5, K)
    assert 0 < int(c) < 0.75 * nb
    assert cand.shape == (nb,)
