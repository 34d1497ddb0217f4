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
from rejit_tpu_torch.engine import schain as tschain
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
KJ = 4                       # test_plain_equals_call_fused's fused block
PJ = KJ * 8 * CHL * CHUNKS
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


def _call(st, n_patterns, count_only, staged, n, seed, block=K):
    return schain_pallas.call_fused(
        st, n_patterns, staged, n, block=block, chl=CHL, interpret=True,
        seed=seed, count_only=count_only,
    )[:3]


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("pats", PATS, ids=IDS)
def test_plain_equals_call_fused(pats):
    """L/I, count and G, with the solo and a neutral seed, at n = P, P-3, a
    chunk edge, one past it, 1 and 0. Fused block 4 (half the file's K):
    the interpret-mode traces, two a pattern set, take ~40% less time."""
    K, P = KJ, PJ
    t, ct, text = _setup(pats)
    text = text[:P]
    st = jschain.static_tables(t)
    Q = t.n_states
    staged = schain_pallas.stage_text(st, jnp.asarray(text), block=K,
                                      chl=CHL)
    start_eot = int(staged[2])
    jplan = schain_pallas._plan(st, K)
    run = {co: jax.jit(functools.partial(_call, st, t.n_patterns, co,
                                         block=K))
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
            # Boundary P, which the JAX kernel leaves to its callers: the
            # seed at the start state after the last byte, when n == P.
            eot = _np(jseed)[:, start_eot] if n == P else np.array([-1, -1,
                                                                     -1])
            L, I, G = schain_cuda.schain_fused(ct, tt, n, seed, block=K,
                                               mode=mode)
            assert L.shape == (P + 1,)
            np.testing.assert_array_equal(L.numpy(), np.append(L_ref, eot[1]),
                                          what)
            np.testing.assert_array_equal(G.numpy(), _np(G_ref), what)
            if mode == "li":
                I_ref = np.where(
                    live, _np(schain_pallas.untile(It, nbc, K, CHL)), -1
                )
                np.testing.assert_array_equal(I.numpy(),
                                              np.append(I_ref, eot[2]), what)
            else:
                assert I is None
            cnt_ref, _, Gc_ref = run[True](staged, jnp.int32(n), jseed)
            cnt, none, Gc = schain_cuda.schain_fused(ct, tt, n, seed,
                                                     block=K, mode="count")
            assert none is None
            assert int(cnt) == int(_np(cnt_ref)[0, 0]) + (eot[1] >= 0), what
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
    """l_arrays_device_staged (the kernel's P+1 buffers: EOT row, -1 past n;
    no I for one pattern, read as pid 0) and count_device_staged against
    the JAX package's L-array pipeline, which its own tests hold equal to
    the fused kernel."""
    t, ct, text = _setup(pats)
    jct = jpipe.device_tables(t)
    tt = torch.from_numpy(text)
    for n in (P, P - 3, P // 2, 1, 0):
        L_ref, I_ref = jpipe.l_arrays_device(jct, jnp.asarray(text),
                                             jnp.int32(n), block=K)
        for use_ff in (True, False):
            L, I = schain_cuda.l_arrays_device_staged(
                ct, tt, n, block=K, use_ff=use_ff
            )
            np.testing.assert_array_equal(L.numpy(), _np(L_ref), f"n={n}")
            if I is None:
                assert t.n_patterns == 1
                I = torch.where(L >= 0, 0, -1)
            np.testing.assert_array_equal(I.numpy(), _np(I_ref), f"n={n}")
        cnt = schain_cuda.count_device_staged(ct, tt, n, block=K)
        assert int(cnt) == int((_np(L_ref) >= 0).sum()), f"n={n}"
    L, I = schain_cuda.l_arrays_device_staged(ct, tt, P - 3, block=16)
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
    # The start state at boundary P, from which the kernel reads the seed
    # for its EOT row.
    _, _, start_eot = schain_pallas.stage_text(st, jnp.asarray(text),
                                               block=K, chl=CHL)
    assert int(pipeline.start_eot(ct, torch.from_numpy(text))) == (
        int(start_eot))


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
    for Q, P_ in ((6, 10_000_000), (256, 1 << 20), (2, 4096), (6, 32)):
        NB, ntiles, tps, nseg = schain_cuda.geometry(Q, P_)
        assert NB & (NB - 1) == 0 and NB * Q <= schain_cuda.GRID_STATES
        assert schain_cuda.TILE % (NB * schain_cuda.PIECE) == 0
        T = schain_cuda.TILE
        assert ntiles * T >= P_ > (ntiles - 1) * T
        assert nseg <= schain_cuda.MAX_SEGMENTS
        assert (nseg - 1) * tps < ntiles <= nseg * tps
    with pytest.raises(ValueError):
        schain_cuda.geometry(0, 4096)


# ---------------------------------------------------------------------------
# A numpy model of the kernel's sweep instance (Q <= 32), against the plain
# version: chunk summaries from the identity by the backward sweep (and by
# the forward pass with its all-dead stop, which the kernel's pass 1 runs),
# exclusive suffixes from the seed, the emitting sweep from each chunk's
# suffix with the 128-byte FF tile skip, and the identity past n.
# ---------------------------------------------------------------------------

TILE = schain_cuda.SWEEP_TILE
SPARSE = np.frombuffer(b".,;:-!? ", np.uint8)


def _compose(a, b):
    """a, then b: (f, m, i) numpy vectors indexed by state."""
    fa, ma, ia = a
    fb, mb, ib = b
    later = mb[fa] >= 0
    return fb[fa], np.where(later, mb[fa], ma), np.where(later, ib[fa], ia)


def _sweep(T, Q, text, lo, hi, n, V, out=None):
    """Bytes [lo, hi) right to left from V, the vector right of hi, one
    state per lane. With `out` = (L, I), boundary j+1 gets V at its start
    state: read by lane Q (an idle lane whose next state is that start
    state, its i taken whatever its m) after byte j, or, with no idle lane,
    by a shuffle before it."""
    W = T.shape[1]
    lanes = np.arange(W)
    for j in range(hi - 1, lo - 1, -1):
        if j >= n:   # identity; boundary j+1 lies past n
            if out is not None:
                out[0][j + 1] = out[1][j + 1] = -1
            continue
        e = T[text[j], lanes]
        if out is not None and Q == W:
            st = e[0] >> 24
            out[0][j + 1], out[1][j + 1] = V[1][st], V[2][st]
        nq = e & 255
        a1 = (e >> 8) & 255
        later = V[1][nq] >= 0
        V = (V[0][nq], np.where(later, V[1][nq], np.where(a1 > 0, j, -1)),
             np.where(later | (lanes == Q), V[2][nq], a1 - 1))
        if out is not None and Q < W:
            out[0][j + 1], out[1][j + 1] = V[1][Q], V[2][Q]
    return V


def _forward(T, Q, text, lo, hi, dead):
    """The kernel's pass 1: every state forward through [lo, hi), checked
    for the all-dead stop after each 16 bytes."""
    S = np.arange(T.shape[1])
    m = np.full(len(S), -1)
    i = np.full(len(S), -1)
    for pos in range(lo, hi):
        e = T[text[pos], S]
        a1 = (e >> 8) & 255
        m = np.where(a1 > 0, pos, m)
        i = np.where(a1 > 0, a1 - 1, i)
        S = e & 255
        if dead >= 0 and (pos - lo) % 16 == 15 and (S[:Q] == dead).all():
            break
    return S, m, i


def _emit(T, Q, text, lo, hi, n, V, out, dead, skip):
    """Pass 3 on one chunk, tile by tile from the right, with the FF skip
    (first byte uniform, the rest silent, no match from dead beyond)."""
    skipped = 0
    lanes = np.arange(T.shape[1])
    for tb in reversed(range(lo, hi, TILE)):
        te = min(tb + TILE, hi)
        if skip and te == tb + TILE and te <= n:
            fl = (T[text[tb:te], 0] >> 16) & 255
            if (fl[0] & tschain.UNIFORM and (fl[1:] & tschain.SILENT).all()
                    and V[1][dead] < 0):
                st = T[text[te - 1], 0] >> 24
                out[0][te], out[1][te] = V[1][st], V[2][st]
                out[0][tb + 1:te] = out[1][tb + 1:te] = -1
                a1 = (T[text[tb], lanes] >> 8) & 255
                V = (np.full(len(lanes), V[0][dead]),
                     np.where(a1 > 0, tb, -1), a1 - 1)
                skipped += 1
                continue
        V = _sweep(T, Q, text, tb, te, n, V, out)
    return V, skipped


def _sweep_model(ct, text, n, seed, chunk, skip):
    Q = ct.n_states
    W = 1 << (Q - 1).bit_length()
    T = tschain.sweep_table(ct.static, W).astype(np.int64)
    dead = -1 if ct.plan.dead is None else ct.plan.dead
    P = len(text)
    idle = np.arange(Q, W)
    ones = -np.ones(W - Q, np.int64)
    seedv = tuple(np.concatenate([x, y]) for x, y in
                  zip(seed.astype(np.int64), (idle, ones, ones)))
    ident = (np.arange(W), -np.ones(W, np.int64), -np.ones(W, np.int64))
    los = list(range(0, P, chunk))
    summ = []
    for lo in los:
        hi = min(lo + chunk, P)
        s_b = _sweep(T, Q, text, lo, hi, n, ident)
        s_f = _forward(T, Q, text, lo, min(hi, n), dead)
        for x, y in zip(s_b, s_f):
            np.testing.assert_array_equal(x[:Q], y[:Q])
        summ.append(s_b)
    X = [None] * len(los)
    V = seedv
    for k in reversed(range(len(los))):
        X[k] = V
        V = _compose(summ[k], V)
    L = np.full(P + 1, -9)
    I = np.full(P + 1, -9)
    skipped = 0
    ends = []
    for k, lo in enumerate(los):
        Vk, sk = _emit(T, Q, text, lo, min(lo + chunk, P), n, X[k], (L, I),
                       dead, skip and dead >= 0)
        ends.append(Vk)
        skipped += sk
    for x, y in zip(ends[0], V):  # chunk 0's sweep ends at the text's map
        np.testing.assert_array_equal(x[:Q], y[:Q])
    st0 = ct.plan.start_by_ctx[0]
    L[0], I[0] = V[1][st0], V[2][st0]
    return L, I, np.stack([x[:Q] for x in V]), skipped


def _model_text(kind, size, seed):
    rng = np.random.default_rng(seed)
    if kind == "soup":
        return rng.choice(SOUP, size=size).astype(np.uint8)
    text = rng.choice(SPARSE, size=size).astype(np.uint8)
    for at in (150, 420):
        text[at:at + 7] = np.frombuffer(b"singing", np.uint8)
    return text


@pytest.mark.parametrize("kind", ["soup", "sparse"])
@pytest.mark.parametrize("pats", PATS, ids=IDS)
def test_sweep_model_equals_plain(pats, kind):
    """The sweep instance's algebra, in numpy, equals schain_fused_plain in
    the L, L+I and count modes, with the solo and a neutral seed, chunks of
    one and three tiles, the FF tile skip on and off, and n at P, P-3,
    mid-chunk, a tile edge, 1 and 0."""
    _, ct, _ = _setup(pats)
    Pm = 5 * TILE
    text = _model_text(kind, Pm, len(pats[0]))
    tt = torch.from_numpy(text)
    Q = ct.n_states
    skipped = 0
    for n in (Pm, Pm - 3, 300, 2 * TILE, 1, 0):
        seeds = {"solo": schain_cuda.solo_seed(ct, n),
                 "neutral": schain_cuda.neutral_seed(Q)}
        for name, seed in seeds.items():
            what = f"n={n} seed={name}"
            L, I, G = schain_cuda.schain_fused(ct, tt, n, seed, block=K,
                                               mode="li")
            cnt = schain_cuda.schain_fused(ct, tt, n, seed, block=K,
                                           mode="count")[0]
            Lp, _, _ = schain_cuda.schain_fused(ct, tt, n, seed, block=K,
                                                mode="l")
            for chunk, skip in ((TILE, True), (3 * TILE, True),
                                (3 * TILE, False)):
                mL, mI, mG, sk = _sweep_model(ct, text, n, seed.numpy(),
                                              chunk, skip)
                skipped += sk
                np.testing.assert_array_equal(mL, L.numpy(), what)
                np.testing.assert_array_equal(mL, Lp.numpy(), what)
                np.testing.assert_array_equal(mI, I.numpy(), what)
                np.testing.assert_array_equal(mG, G.numpy(), what)
                assert int((mL >= 0).sum()) == int(cnt), what
    if kind == "sparse" and ct.plan.skip:
        assert skipped > 0


def test_sweep_table_and_geometry():
    _, ct, _ = _setup((rb"\w+", rb"\s+", rb"[^\w\s]+"))
    Q = ct.n_states
    W = 1 << (Q - 1).bit_length()
    T = tschain.sweep_table(ct.static, W).astype(np.int64)
    packed = ct.packed.numpy()
    for b in (0, 32, 65, 200):
        c = int(ct.class_of[b])
        for q in range(W):
            if q < Q:
                v = packed[q * ct.n_classes + c]
                assert T[b, q] & 0xFFFF == (v >> 8) | (v & 255) << 8
            else:   # idle lanes step to the start state, never accept
                assert T[b, q] & 0xFFFF == int(ct.start_of_byte[b])
            assert T[b, q] >> 24 == int(ct.start_of_byte[b])
            assert (T[b, q] >> 16) & 255 == int(ct.byte_flags[b])
    assert schain_cuda.instance_for(32) == "sweep"
    assert schain_cuda.instance_for(33) == "tile"
    for Q_, P_, cap in ((6, 10_000_000, 792), (32, 1 << 28, 660), (1, 32, 8),
                        (17, 5000, 1), (3, 4096, 2000)):
        W, ntiles, tpc, nseg = schain_cuda.sweep_geometry(Q_, P_, cap)
        assert W >= Q_ > W // 2 or W == Q_ == 1
        assert ntiles == -(-P_ // TILE)
        groups = schain_cuda.SWEEP_THREADS // W
        assert nseg <= min(cap, schain_cuda.MAX_SEGMENTS)
        assert (nseg - 1) * groups * tpc < ntiles <= nseg * groups * tpc
    with pytest.raises(ValueError):
        schain_cuda.sweep_geometry(33, 4096, 10)
