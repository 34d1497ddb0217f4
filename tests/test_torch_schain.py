"""The port's fused DFA kernel (plain version) == the JAX package's
schain_pallas.call_fused, exactly.

Same numpy inputs and identical tables (through device_tables_from_arrays)
go to both sides. The JAX side runs call_fused in interpret mode, as its
own tests do on the CPU, jitted once per pattern set and mode so that one
trace serves every n and seed; the port runs schain_fused on CPU tensors,
i.e. its plain version. Every value is an int32 position, state, id or
count, so the tolerance is exact equality.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rejit_tpu.compile import parser as jax_parser
from rejit_tpu.compile.dfa import compile_patterns
from rejit_tpu.engine import pipeline as jpipe
from rejit_tpu.engine import schain as jschain
from rejit_tpu.kernels import schain_pallas
from rejit_tpu_torch.engine import pipeline
from rejit_tpu_torch.kernels import schain_cuda

# Small inputs: one intra-op thread keeps the xdist workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

PATS = [
    (rb"\b\w+ing\b",), (rb"[a-z]+",), (rb"foo|bar|baz",), (rb"a*",),
    (rb"^line.*$",), (rb"\w+", rb"\s+", rb"[^\w\s]+"),
]
IDS = ["+".join(p.decode() for p in ps) for ps in PATS]
K, CHL, CHUNKS = 8, 2, 2
P = K * 8 * CHL * CHUNKS
SOUP = np.frombuffer(b"abc defoo barbaz ing singing\n working!", np.uint8)


def _setup(pats):
    t = compile_patterns([jax_parser.parse(p) for p in pats])
    ct = pipeline.device_tables_from_arrays(
        t.class_of, t.next, t.accept, t.accept_eot, t.start_states, t.dead,
        t.n_patterns, device="cpu",
    )
    rng = np.random.default_rng(sum(map(len, pats)) * 7919)
    text = rng.choice(SOUP, size=P).astype(np.uint8)
    return t, ct, text


def _call(st, n_patterns, count_only, staged, n, seed):
    return schain_pallas.call_fused(
        st, n_patterns, staged, n, block=K, chl=CHL, interpret=True,
        seed=seed, count_only=count_only,
    )[:3]


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("pats", PATS, ids=IDS)
def test_plain_equals_call_fused(pats):
    """L/I, count and G, with the solo and a neutral seed, at n = P, P-3, a
    chunk edge, one past it, 1 and 0."""
    t, ct, text = _setup(pats)
    st = jschain.static_tables(t)
    Q = t.n_states
    staged = schain_pallas.stage_text(st, jnp.asarray(text), block=K,
                                      chl=CHL)
    jplan = schain_pallas._plan(st, K)
    run = {co: jax.jit(functools.partial(_call, st, t.n_patterns, co))
           for co in (False, True)}
    mode = "li" if t.n_patterns > 1 else "l"
    nbc = P // (K * 8 * CHL)
    tt = torch.from_numpy(text)
    for n in (P, P - 3, P // 2, P // 2 + 1, 1, 0):
        seeds = {
            "solo": (schain_pallas.solo_seed(jplan, jnp.int32(n)),
                     schain_cuda.solo_seed(ct, n)),
            "neutral": (schain_pallas.neutral_seed(Q),
                        schain_cuda.neutral_seed(Q)),
        }
        for name, (jseed, seed) in seeds.items():
            what = f"n={n} seed={name}"
            np.testing.assert_array_equal(seed.numpy(), _np(jseed), what)
            Lt, It, G_ref = run[False](staged, jnp.int32(n), jseed)
            live = np.arange(P) <= n
            L_ref = np.where(live, _np(schain_pallas.untile(Lt, nbc, K, CHL)),
                             -1)
            L, I, G = schain_cuda.schain_fused(ct, tt, n, seed, block=K,
                                               mode=mode)
            np.testing.assert_array_equal(L.numpy(), L_ref, what)
            np.testing.assert_array_equal(G.numpy(), _np(G_ref), what)
            if mode == "li":
                I_ref = np.where(
                    live, _np(schain_pallas.untile(It, nbc, K, CHL)), -1
                )
                np.testing.assert_array_equal(I.numpy(), I_ref, what)
            else:
                assert I is None
            cnt_ref, _, Gc_ref = run[True](staged, jnp.int32(n), jseed)
            cnt, none, Gc = schain_cuda.schain_fused(ct, tt, n, seed,
                                                     block=K, mode="count")
            assert none is None
            assert int(cnt) == int(_np(cnt_ref)[0, 0]), what
            assert int(cnt) == int((L >= 0).sum()), what
            # The JAX count kernel tracks no pattern ids, so its G holds
            # 0/-1 in the id row for several patterns
            # (schain_pallas.py:902-904); f and m agree always.
            rows = 3 if t.n_patterns == 1 else 2
            np.testing.assert_array_equal(Gc.numpy()[:rows],
                                          _np(Gc_ref)[:rows], what)
            np.testing.assert_array_equal(Gc.numpy(), G.numpy(), what)


@pytest.mark.parametrize("pats", PATS, ids=IDS)
def test_staged_wrappers_equal_jax_pipeline(pats):
    """l_arrays_device_staged (EOT row, masking, I of one pattern) and
    count_device_staged (the n == P epilogue) against the JAX package's
    L-array pipeline, which its own tests hold equal to the fused kernel."""
    t, ct, text = _setup(pats)
    jct = jpipe.device_tables(t)
    tt = torch.from_numpy(text)
    staged = (tt, schain_cuda.stage_meta(ct, tt))
    for n in (P, P - 3, P // 2, 1, 0):
        L_ref, I_ref = jpipe.l_arrays_device(jct, jnp.asarray(text),
                                             jnp.int32(n), block=K)
        for use_ff in (True, False):
            L, I = schain_cuda.l_arrays_device_staged(
                ct, staged, n, block=K, use_ff=use_ff
            )
            np.testing.assert_array_equal(L.numpy(), _np(L_ref), f"n={n}")
            np.testing.assert_array_equal(I.numpy(), _np(I_ref), f"n={n}")
        cnt = schain_cuda.count_device_staged(ct, staged, n, block=K)
        assert int(cnt) == int((_np(L_ref) >= 0).sum()), f"n={n}"
    L, I = schain_cuda.l_arrays_device_schain_fused(ct, tt, P - 3, block=16)
    np.testing.assert_array_equal(L.numpy(), pipeline.l_arrays_device(
        ct, tt, P - 3, block=K)[0].numpy())


@pytest.mark.parametrize("pats", PATS, ids=IDS)
def test_static_tables_plan_and_meta_equal_jax(pats):
    t, ct, text = _setup(pats)
    st = jschain.static_tables(t)
    assert ct.static == st
    jp = schain_pallas._plan(st, K)
    fp = ct.plan
    assert (fp.dead, fp.skip) == (jp["dead"], jp["skip"])
    assert fp.silent_runs == jp["silent_runs"]
    assert fp.uni0_runs == jp["uni0_runs"]
    assert fp.accept_eot == jp["accept_eot"]
    allb = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        schain_cuda.start_states_for(ct, torch.from_numpy(allb)).numpy(),
        _np(schain_pallas.start_states_for(st, jnp.asarray(allb))),
    )
    _, _, start_eot = schain_pallas.stage_text(st, jnp.asarray(text),
                                               block=K, chl=CHL)
    assert int(schain_cuda.stage_meta(ct, torch.from_numpy(text))) == int(
        start_eot)


def test_skip_plan_for_sparse_patterns():
    """The FF skip is on for the word patterns and its byte flags mark the
    punctuation of a sparse text silent."""
    _, ct, _ = _setup((rb"\b\w+ing\b",))
    assert ct.plan.skip and ct.plan.dead is not None
    flags = ct.byte_flags.numpy()
    for b in b".,;:-!? ":
        assert flags[b] & 1, chr(b)
    for b in b"az09_":
        assert not flags[b] & 1, chr(b)
    _, ct, _ = _setup((rb"a*",))
    assert not ct.plan.skip


def test_geometry():
    for Q, K_, P_ in ((6, 32, 10_000_000), (256, 32, 1 << 20), (2, 2048, 4096),
                      (6, 32, 32)):
        NB, ntiles, tps, nseg = schain_cuda.geometry(Q, K_, P_)
        assert NB & (NB - 1) == 0 and NB * Q <= schain_cuda.TILE_STATES
        assert NB * K_ <= schain_cuda.TILE_BYTES
        assert ntiles * NB * K_ >= P_ > (ntiles - 1) * NB * K_
        assert nseg <= schain_cuda.MAX_SEGMENTS
        assert (nseg - 1) * tps < ntiles <= nseg * tps
    with pytest.raises(ValueError):
        schain_cuda.geometry(6, 4096, 4096)
