"""The port's DFA phases and pipeline == the JAX package's, exactly.

Same numpy inputs and identical tables (through device_tables_from_arrays)
go to both sides. The JAX side runs its Pallas kernels in interpret mode,
as its own tests do on the CPU; the port runs its kernels' plain versions
(CPU tensors). Every value is an int32 position, state or id, so the
tolerance is exact equality.
"""
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

PATS = [
    (rb"\w+ing\b",), (rb"[a-z]+",), (rb"foo|bar",), (rb"a*",), (rb"^line",),
    (rb"\b\w+ing\b",), (rb"\w+", rb"\s+", rb"[^\w\s]+"),
]
IDS = ["|".join(p.decode() for p in s) for s in PATS]
K = 8


def _tables(pats):
    t = compile_patterns([jax_parser.parse(p) for p in pats])
    ct = pipeline.device_tables_from_arrays(
        t.class_of, t.next, t.accept, t.accept_eot, t.start_states, t.dead,
        t.n_patterns, device="cpu",
    )
    return jpipe.device_tables(t), ct


def _text(pats, nb, sparse=False):
    P = nb * K
    rng = np.random.default_rng(sum(map(len, pats)) * 7919 + nb)
    if sparse:
        text = rng.choice(np.frombuffer(b" .,;", np.uint8), size=P)
        for a in rng.choice(P - 8, size=P // 400, replace=False):
            text[a:a + 7] = np.frombuffer(b"singing", np.uint8)
        return text.astype(np.uint8)
    return rng.choice(
        np.frombuffer(b"abfo liner\n singing!", np.uint8), size=P
    ).astype(np.uint8)


def _setup(pats, nb_chunks=1):
    jct, ct = _tables(pats)
    nb = dfa_pallas.CHUNK * nb_chunks
    text = _text(pats, nb)
    n = nb * K - 3
    cls, ctx = jpipe.classify(jct, jnp.asarray(text))
    starts = jnp.concatenate([jct.start_by_ctx[:1], jct.start_by_ctx[ctx[:-1]]])
    cls_kb = np.asarray(jpipe.block_views(cls, nb, K))
    startsb = np.asarray(jpipe.block_views(starts, nb, K))
    return jct, ct, text, n, cls_kb, startsb


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32, order="C"))


def _eq(mine, ref):
    if isinstance(mine, tuple):
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            _eq(a, b)
        return
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


def _jax_suf(jct, cls_kb, n):
    summ = dfa_pallas.phase1_pallas(
        jct.packed, jct.n_classes, jnp.asarray(cls_kb), jnp.int32(n), K=K,
        interpret=True,
    )
    return summ, jpipe.suffix_scan(summ, jpipe.eot_seed(jct, jnp.int32(n)))


@pytest.mark.parametrize("pats", PATS, ids=IDS)
def test_phases_and_suffix_scan_equal_pallas(pats):
    jct, ct, _, n, cls_kb, startsb = _setup(pats)
    summ_ref, suf_ref = _jax_suf(jct, cls_kb, n)
    summ = dfa_cuda.phase1(ct.packed, ct.n_classes, _t(cls_kb), n)
    _eq(summ, summ_ref)
    suf = pipeline.suffix_scan(summ, pipeline.eot_seed(ct, n))
    _eq(suf, suf_ref)
    L, I = dfa_cuda.phase3(
        ct.packed, ct.n_classes, suf, _t(cls_kb), _t(startsb), n
    )
    _eq((L, I), dfa_pallas.phase3_pallas(
        jct.packed, jct.n_classes, suf_ref, jnp.asarray(cls_kb),
        jnp.asarray(startsb), jnp.int32(n), K=K, interpret=True,
    ))


@pytest.mark.parametrize("pats", PATS[:2], ids=IDS[:2])
def test_phase3_posbase_equals_pallas(pats):
    """Gathered blocks (as the fast-forward route sends them) from a
    two-chunk text, some columns masked by a base of n."""
    jct, ct, _, n, cls_kb, startsb = _setup(pats, nb_chunks=2)
    _, suf_ref = _jax_suf(jct, cls_kb, n)
    rng = np.random.default_rng(3)
    nb = cls_kb.shape[1]
    idx = np.sort(rng.choice(nb, size=dfa_pallas.CHUNK, replace=False))
    posbase = (idx * K).astype(np.int32)
    posbase[rng.random(len(idx)) < 0.1] = n
    suf_c = tuple(np.asarray(x)[idx] for x in suf_ref)
    cls_c, starts_c = cls_kb[:, idx], startsb[:, idx]
    L, I = dfa_cuda.phase3(
        ct.packed, ct.n_classes, tuple(_t(x) for x in suf_c), _t(cls_c),
        _t(starts_c), n, posbase=_t(posbase),
    )
    _eq((L, I), dfa_pallas.phase3_pallas(
        jct.packed, jct.n_classes, tuple(jnp.asarray(x) for x in suf_c),
        jnp.asarray(cls_c), jnp.asarray(starts_c), jnp.int32(n),
        posbase=jnp.asarray(posbase), K=K, interpret=True,
    ))


@pytest.mark.parametrize("pats", PATS, ids=IDS)
def test_l_arrays_device_equals_jax(pats):
    jct, ct, text, n, _, _ = _setup(pats)
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
    jct, ct = _tables(pats)
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
    _, ct = _tables((rb"\b\w+ing\b",))
    nb = 256
    text = _text((rb"\b\w+ing\b",), nb, sparse=True)
    v = pipeline.views(ct, torch.from_numpy(text), K)
    _, cand, c = pipeline.ff_phase12(ct, v, nb * K - 5)
    assert 0 < int(c) < 0.75 * nb
    assert cand.shape == (nb,)
