"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes, and the counter on the card against the counter on the
CPU.  Every output is an integer: exact equality.

Marked `cuda`; each test skips where torch.cuda.is_available() is False.
This file imports no JAX, so on a machine with a GPU and without JAX it runs
on its own (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu_torch import KmerCounter  # noqa: E402
from tsxcount_tpu_torch.ops.compact import (  # noqa: E402
    compact_flagged,
    compact_flagged_plain,
)
from tsxcount_tpu_torch.ops.merge import merge_sorted, merge_sorted_plain  # noqa: E402
from tsxcount_tpu_torch.ops.merge_dedupe import (  # noqa: E402
    merge_dedupe_sorted,
    merge_dedupe_sorted_plain,
)

pytestmark = pytest.mark.cuda
INV_MIN = 1 << 30


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a: np.ndarray, dev) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a
                            ).to(dev)


@pytest.mark.parametrize("total,density", [(1, 1.0), (5000, 0.5),
                                           (9000, 0.0), (9000, 1.0),
                                           (123457, 0.1)])
def test_compact_kernel(dev, total, density):
    rng = np.random.default_rng(total)
    flag = _t((rng.random(total) < density).astype(np.int32), dev)
    cols = (_t(rng.integers(0, 2**32, total, dtype=np.uint32), dev),
            _t(rng.integers(-2**62, 2**62, total), dev))
    got = compact_flagged(flag, cols)
    want = compact_flagged_plain(flag, cols)
    n = int((flag != 0).sum())
    for g, w in zip(got, want):
        assert torch.equal(g[:n], w[:n])


def _sorted_run(rng, n, n_keys, hi):
    keys = rng.integers(0, hi, size=(n, n_keys), dtype=np.uint64)
    keys = keys.astype(np.uint32)
    return keys[np.lexsort(keys.T[::-1])]


@pytest.mark.parametrize("m,n,n_keys,hi", [
    (1024, 1024, 1, 2**32), (2000, 48, 1, 50), (0, 2048, 2, 2**32),
    (30000, 15000, 2, 4), (7000, 29000, 3, 3), (5, 0, 1, 9),
    (40000, 40000, 8, 2),
])
def test_merge_kernel(dev, m, n, n_keys, hi):
    rng = np.random.default_rng(m + n + n_keys)
    a_keys, b_keys = (_sorted_run(rng, m, n_keys, hi),
                      _sorted_run(rng, n, n_keys, hi))
    a = tuple(_t(a_keys[:, j], dev) for j in range(n_keys)) + (
        torch.arange(m, dtype=torch.int32, device=dev),
        _t(rng.integers(0, 2**40, m), dev))
    b = tuple(_t(b_keys[:, j], dev) for j in range(n_keys)) + (
        torch.arange(n, dtype=torch.int32, device=dev) + 100000,
        _t(rng.integers(0, 2**40, n), dev))
    for g, w in zip(merge_sorted(a, b, n_keys),
                    merge_sorted_plain(a, b, n_keys)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m,n,n_keys,hi,n_inv", [
    (40960, 20480, 1, 3000, 37), (60000, 30000, 2, 30, 0),
    (90000, 100, 1, 2, 5), (0, 10, 1, 5, 3), (3, 0, 3, 2, 0),
    (20000, 20000, 8, 2, 11),
])
def test_merge_dedupe_kernel(dev, m, n, n_keys, hi, n_inv):
    rng = np.random.default_rng(m + n)

    def run(k):
        keys = _sorted_run(rng, k, n_keys, hi)
        cnt = rng.integers(2**31, 2**32, k)
        inv = min(n_inv, k)
        keys[k - inv :] = 0
        keys[k - inv :, 0] = INV_MIN
        cnt[k - inv :] = 0
        return tuple(_t(keys[:, j], dev) for j in range(n_keys)) + (
            _t(cnt, dev),)

    a, b = run(m), run(n)
    got, g_runs, g_valid = merge_dedupe_sorted(a, b, n_keys, INV_MIN)
    want, w_runs, w_valid = merge_dedupe_sorted_plain(a, b, n_keys, INV_MIN)
    assert (int(g_runs), int(g_valid)) == (int(w_runs), int(w_valid))
    r = int(w_runs)
    for g, w in zip(got, want):
        assert torch.equal(g[:r], w[:r])


@pytest.mark.parametrize("k", [14, 16, 33])
def test_counter_on_card_matches_cpu(dev, k):
    rng = np.random.default_rng(k)
    reads = ["".join(rng.choice(list("ACGTN"), size=rng.integers(k, 400)))
             for _ in range(300)]
    out = []
    for d in (dev, "cpu"):
        c = KmerCounter(k=k, l=16, batch_words=512, merge_every=3, device=d)
        c.add_reads(reads)
        c.finish()
        out.append((c.to_dict(), c.distinct, c.total_kmers))
    assert out[0] == out[1]
