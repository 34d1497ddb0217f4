"""The scan1d kernel (kernels/csrc/scan1d.cu) on the card against its plain
versions, bit for bit: at the kernel's tile edges and on inputs over the
whole int32 range (INT_MIN and INT_MAX included, the extremes in the first
and in the last tile), on offset views x[1:] (4 bytes off a 16-byte
boundary), and over repeated calls, each counted once.

Every test needs a CUDA card and skips without one (the kernel has no CPU
form; its plain versions are held against rejit_tpu in
tests/test_torch_classrun.py). This file imports no JAX, so it also runs
on the card's machine, where the repo's conftest (which imports JAX) is
skipped: python -m pytest --noconftest -o addopts="" -m cuda
tests/test_torch_scan_cuda.py
"""
import pytest
import torch

from rejit_tpu_torch.kernels import scan_cuda

REPEATS = 200


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the scan1d kernel has no CPU form)")
    return torch.device("cuda")


def _inputs(P: int, tile: int, g, dev) -> list:
    """Random over the whole int32 range, that sorted, and small values
    with INT_MIN and INT_MAX planted anywhere, in the first tile and in
    the last."""
    x = torch.randint(-2**31, 2**31, (P,), dtype=torch.int32, device=dev,
                      generator=g)
    out = [x, torch.sort(x).values]
    for lo, hi in ((0, P), (0, min(P, tile)), (max(0, P - tile), P)):
        y = torch.randint(-1000, 1000, (P,), dtype=torch.int32, device=dev,
                          generator=g)
        at = torch.randint(lo, hi, (4,), device=dev, generator=g)
        y[at[:2]] = -2**31
        y[at[2:]] = 2**31 - 1
        out.append(y)
    return out


def _both_equal(x) -> bool:
    return (torch.equal(scan_cuda.rcummin(x), scan_cuda.rcummin_plain(x))
            and torch.equal(scan_cuda.cummax(x), scan_cuda.cummax_plain(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("tiles,extra", [(0, 1), (0, 31), (1, -1), (1, 0),
                                         (1, 1), (2, -1), (2, 0), (2, 1),
                                         (244, 577)])
def test_kernel_equals_plain_at_tile_edges(card, tiles, extra):
    tile = scan_cuda._kernels().scan1d_tile_elems()
    P = tiles * tile + extra
    g = torch.Generator(device=card).manual_seed(P)
    for x in _inputs(P, tile, g, card):
        assert _both_equal(x)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4098, 10_000_001])
def test_kernel_equals_plain_on_offset_view(card, P):
    tile = scan_cuda._kernels().scan1d_tile_elems()
    g = torch.Generator(device=card).manual_seed(P)
    for x in _inputs(P, tile, g, card):
        view = x[1:]
        assert view.data_ptr() % 16 == 4
        assert _both_equal(view)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [1, 5, 2442])
def test_repeated_calls_equal_plain_and_count_one_each(card, tiles):
    tile = scan_cuda._kernels().scan1d_tile_elems()
    P = tiles * tile + 3
    g = torch.Generator(device=card).manual_seed(P)
    x = torch.randint(-2**31, 2**31, (P,), dtype=torch.int32, device=card,
                      generator=g)
    want = scan_cuda.rcummin_plain(x), scan_cuda.cummax_plain(x)
    scan_cuda.reset_launches()
    differ = 0
    for _ in range(REPEATS):
        differ += not torch.equal(scan_cuda.rcummin(x), want[0])
        differ += not torch.equal(scan_cuda.cummax(x), want[1])
    assert differ == 0
    assert scan_cuda.LAUNCHES == {"scan1d": 2 * REPEATS}
