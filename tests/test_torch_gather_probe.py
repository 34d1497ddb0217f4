"""The gather probe (kernels/probe_cuda.py): the port's plain gather_chain
against bench/gather_probe.py's Pallas kernel in interpret mode, bit for bit
(exact equality), and the kernel against the plain version on the card."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rejit_tpu_torch.kernels import probe_cuda
from rejit_tpu_torch.probes import gather_probe

torch.set_num_threads(1)

_JAX = {}


def _jax_probe(mode, U, ITERS, QS):
    """The probe's pallas_call, built as bench/gather_probe.py:71-111 builds
    it (a verbatim copy: the script's kernel is a closure inside main()),
    run in interpret mode. Returns the (8, 128) output for n."""
    args = types.SimpleNamespace(mode=mode)
    interpret = True

    def kernel(n_ref, t_ref, y_ref, o_ref):
        t = t_ref[...]                               # (8,128) int32 perm rows
        n = n_ref[0]
        ys = tuple(
            jnp.clip(y_ref[8 * i:8 * (i + 1), :] + (n & 1), 0, 127)
            for i in range(U)
        )
        if args.mode == "serial":
            def body(_, ys):
                return tuple(jnp.take_along_axis(t, y, axis=-1) for y in ys)
        else:
            consts = [jnp.full((8, 128), (7 * q + 3) % 128, jnp.int32)
                      for q in range(QS)]

            def body(_, ys):
                out = []
                for y in ys:
                    for q in range(QS):
                        y = jnp.where(y == q, consts[q], y)
                    out.append(y)
                return tuple(out)
        ys = jax.lax.fori_loop(0, ITERS, body, ys)
        acc = ys[0]
        for y in ys[1:]:
            acc = acc ^ y
        o_ref[...] = acc

    t_host = np.stack(
        [np.random.RandomState(7 + r).permutation(128).astype(np.int32)
         for r in range(8)]
    )
    y_host = np.random.RandomState(3).randint(
        0, 128, size=(8 * U, 128)).astype(np.int32)
    t_dev = jnp.asarray(t_host)
    y_dev = jnp.asarray(y_host)

    call = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        interpret=interpret,
    )
    return lambda n: np.asarray(call(jnp.int32(n).reshape(1), t_dev, y_dev))


def _jax_out(mode, U, ITERS, QS, n):
    key = (mode, U, ITERS, QS)
    if key not in _JAX:
        _JAX[key] = _jax_probe(mode, U, ITERS, QS)
    return _JAX[key](n)


CASES = [("serial", u, 16, 0) for u in (1, 2)] + [
    ("select", u, 9, qs) for u in (1, 2) for qs in (4, 32)]


@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("mode,u,iters,qs", CASES)
def test_plain_equals_pallas_probe(mode, u, iters, qs, n):
    t, y = gather_probe.inputs(u, "cpu")
    got = probe_cuda.gather_chain(t, y, n, iters=iters, mode=mode, qs=qs,
                                  replicas=2)
    want = _jax_out(mode, u, iters, qs, n)
    assert got.shape == (2, 8, 128) and got.dtype == torch.int32
    for r in range(2):
        np.testing.assert_array_equal(got[r].numpy(), want)


def test_probe_inputs_and_checks(monkeypatch):
    """The inputs are the JAX script's; bad arguments raise; a CPU run
    counts no launch; the JSON fields of a CPU measurement, timed by a
    clock that advances 1 ms a call (the host clock of a loaded CPU can
    stall the R run past the 2R run)."""
    t, y = gather_probe.inputs(3, "cpu")
    assert t.shape == (8, 128) and y.shape == (24, 128)
    assert all(sorted(r.tolist()) == list(range(128)) for r in t)
    np.testing.assert_array_equal(
        y.numpy(), np.random.RandomState(3).randint(0, 128, size=(24, 128)))
    for kw, exc in ((dict(mode="gather"), ValueError),
                    (dict(replicas=0), ValueError),
                    (dict(iters=-1), ValueError)):
        args = {**dict(iters=1, mode="serial", qs=4, replicas=1), **kw}
        with pytest.raises(exc):
            probe_cuda.gather_chain(t, y, 0, **args)
    with pytest.raises(TypeError):
        probe_cuda.gather_chain(t.long(), y, 0, iters=1, mode="serial",
                                qs=0)
    with pytest.raises(ValueError):
        probe_cuda.gather_chain(t, y[:20], 0, iters=1, mode="serial", qs=0)
    big = torch.zeros((8 * 17, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        probe_cuda.gather_chain(t, big, 0, iters=1, mode="serial", qs=0)
    now = [0.0]
    chain = probe_cuda.gather_chain

    def timed_chain(*a, **kw):
        now[0] += 1e-3
        return chain(*a, **kw)

    monkeypatch.setattr(gather_probe, "_clock", lambda: now[0])
    monkeypatch.setattr(probe_cuda, "gather_chain", timed_chain)
    probe_cuda.reset_launches()
    row = gather_probe.measure(mode="select", u=1, iters=2, qs=4,
                               device="cpu")
    assert probe_cuda.LAUNCHES["gather_probe"] == 0
    assert {"mode", "u", "iters", "qs", "sec_per_call", "vreg_ops_per_sec",
            "select_rows_per_sec"} <= set(row)
    assert row["qs"] == 4 and row["device"] == "cpu"
    assert row["sec_per_call"] == pytest.approx(1e-3, rel=1e-9)


def _scripted(cost):
    """(fn, clock, calls): fn advances the clock by cost(call number)."""
    state = {"t": 0.0, "calls": 0}

    def fn():
        state["calls"] += 1
        state["t"] += cost(state["calls"])

    return fn, lambda: state["t"], state


def test_slope_remeasured_after_a_stall(monkeypatch):
    """A stalled R run (calls 26-33 cost 5 s, the rest 1 s) makes the 2R
    run the shorter: the slope is measured again at twice R, the median of
    three, and is the true 1 s a call."""
    fn, clock, state = _scripted(lambda c: 5.0 if 26 <= c <= 33 else 1.0)
    monkeypatch.setattr(gather_probe, "_clock", clock)
    assert gather_probe.seconds_per_call(fn, "cpu") == 1.0
    # warm-up 1, R = 8 (long enough), 2R = 16, the stalled R = 8, then
    # three re-measures at 2R = 32 and R = 16
    assert state["calls"] == 1 + 8 + 16 + 8 + 3 * (32 + 16)


def test_slope_never_positive_raises(monkeypatch):
    fn, clock, _ = _scripted(lambda c: 0.0)
    monkeypatch.setattr(gather_probe, "_clock", clock)
    with pytest.raises(RuntimeError, match="no positive slope"):
        gather_probe.seconds_per_call(fn, "cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the gather_probe kernel has no "
                    "CPU form)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,qs", [("serial", 0), ("select", 8),
                                     ("select", 32), ("select", 128)])
def test_kernel_equals_plain_on_card(card, mode, qs):
    for u in (1, 8):
        t, y = gather_probe.inputs(u, card)
        for n in (0, 1):
            for replicas in (1, 132):
                got = probe_cuda.gather_chain(t, y, n, iters=37, mode=mode,
                                              qs=qs, replicas=replicas)
                want = probe_cuda.gather_chain_plain(
                    t, y, n, iters=37, mode=mode, qs=qs, replicas=replicas)
                assert torch.equal(got, want)


def test_busiest_bank_wavefronts_equals_a_plain_count():
    """The exact count of wavefronts a warp lookup takes, against a loop
    over every warp's 32 loads (bank = address % 32, equal addresses one
    broadcast)."""
    u, iters = 2, 3
    t, y = gather_probe.inputs(u, "cpu")
    T, Y = t.numpy(), np.clip(y.numpy(), 0, 127)
    total = cases = 0
    for _ in range(iters):
        Y = np.stack([T[r % 8][Y[r]] for r in range(8 * u)])
        for r in range(8 * u):
            for w in range(4):
                addrs = set(Y[r, 32 * w:32 * w + 32].tolist())
                total += max(sum(1 for a in addrs if a % 32 == b)
                             for b in range(32))
                cases += 1
    assert gather_probe.busiest_bank_wavefronts(u, iters) == total / cases
    assert 1 < total / cases <= 4
