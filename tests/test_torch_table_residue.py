"""The table's residue phase: its kernel (csrc/table_residue.cu) compiled
with g++ against the thread emulation of tools/cuda_emu and held word for
word against the plain rounds (ops/table_residue.py), the CPU form of the
wrapper, and the table's choice between the two (by the state's device).  The kernel on the card
is held against the plain rounds by tests/test_torch_cuda.py."""

import importlib.util
import pathlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tsxcount_tpu_torch import KmerSpec, _build  # noqa: E402
from tsxcount_tpu_torch.core.table import QuotientTable  # noqa: E402
from tsxcount_tpu_torch.ops.gf2 import GF2Hash  # noqa: E402
from tsxcount_tpu_torch.ops.table_residue import (  # noqa: E402
    table_residue,
    table_residue_plain,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "cuda_emulate", REPO / "tools" / "cuda_emu" / "emulate.py")
emulate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(emulate)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return emulate.build([_build.CSRC / "table_residue.cu"],
                         tmp_path_factory.mktemp("emu"))


@pytest.mark.parametrize("case", emulate.RESIDUE_CASES,
                         ids=[c[0] for c in emulate.RESIDUE_CASES])
def test_emulated_residue_kernel_matches_plain_rounds(emulated, case):
    """Slots, n, spilled, the probe histogram and the rounds run, after
    each of two carries (the second re-inserts half the first's keys)."""
    emulate.check_residue(emulated, case, seed=len(case[0]))


@pytest.mark.parametrize("case", emulate.RESIDUE_CASES[:4],
                         ids=[c[0] for c in emulate.RESIDUE_CASES[:4]])
def test_wrapper_on_the_cpu_runs_the_plain_rounds(case):
    """CPU tensors take the plain rounds and add the rounds they ran into
    the counter."""
    slots, s, carries, r_start, width2, mr = emulate.residue_case(case)
    counters = (torch.tensor(3), torch.tensor(4),
                torch.zeros(mr, dtype=torch.int64))
    rounds = torch.tensor(2)
    want_slots = slots.clone()
    got = table_residue(slots, s, carries[0], r_start, width2, mr,
                        *counters, rounds)
    *want, k = table_residue_plain(want_slots, s, carries[0], r_start,
                                   width2, mr, *counters)
    assert torch.equal(slots, want_slots)
    assert all(map(torch.equal, got, want))
    assert int(rounds) == 2 + k


def test_wrapper_refuses_what_the_kernel_cannot_take():
    _, s, carries, r_start, width2, mr = emulate.residue_case(
        emulate.RESIDUE_CASES[0])
    pos0, cleared, counts, active = carries[0]
    zero = torch.tensor(0)
    hist = torch.zeros(mr, dtype=torch.int64)

    def call(slots, n_slots, carry, width):
        table_residue(slots, n_slots, carry, r_start, width, mr, zero, zero,
                      hist, zero.clone())

    slots = torch.zeros(5 * s, dtype=torch.int32)
    with pytest.raises(ValueError, match="key lanes"):
        call(torch.zeros(21 * s, dtype=torch.int32), s,
             (pos0, cleared * 17, counts, active), width2)
    with pytest.raises(ValueError, match="power of two"):
        call(torch.zeros(5 * 96, dtype=torch.int32), 96, carries[0], width2)
    with pytest.raises(ValueError, match="width2"):
        call(slots, s, carries[0], active.numel() + 1)
    with pytest.raises(ValueError, match="width2"):
        call(slots, s, carries[0], -1)
    with pytest.raises(TypeError):
        call(slots, s, (pos0, cleared, counts, active.int()), width2)


def test_emulated_kernel_refuses_short_scratch(emulated):
    """The library sizes the mask scratch (three 64-bit words a thread for
    each chunk of 2^16 rows) and refuses less, before it launches."""
    slots, s, carries, r_start, _, mr = emulate.residue_case(
        emulate.RESIDUE_CASES[-1])
    pos0, cleared, counts, active = carries[0]
    width = active.numel()
    words = emulated.tsx_table_residue_scratch_words
    assert words(0) == 0 and words(1) == words(1 << 16) == 3 * 1024
    assert words(width) == 3 * 1024 * -(-width // (1 << 16))
    masks = torch.zeros(words(width) - 1, dtype=torch.int64)
    zero, hist = torch.tensor(0), torch.zeros(mr, dtype=torch.int64)
    outs = [torch.empty_like(t) for t in (zero, zero, hist)]
    before = slots.clone()
    rc = emulated.tsx_table_residue(
        slots.data_ptr(), s, len(cleared), pos0.data_ptr(),
        _build.ptr_array(cleared), counts.data_ptr(), active.data_ptr(),
        width, width, r_start, mr, zero.data_ptr(), zero.data_ptr(),
        hist.data_ptr(), mr, *(o.data_ptr() for o in outs),
        zero.data_ptr(), masks.data_ptr(), masks.numel(), None)
    assert rc != 0 and torch.equal(slots, before)


def _table(l_bits=12):
    spec = KmerSpec(14)
    return QuotientTable(spec, l_bits, GF2Hash(spec, seed=5),
                         device="cpu")


def test_table_on_the_cpu_counts_plain_rounds_and_no_launch():
    """A CPU state takes the plain rounds; the rounds are counted on the
    host, no residue launch is, and init_state restarts both."""
    t = _table()
    st = t.init_state()
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(np.unique(rng.integers(0, 4**14, 3000))
                            .astype(np.int32))[:, None]
    counts = torch.from_numpy(rng.integers(1, 9, keys.shape[0]))
    st = t.insert(st, keys, counts, torch.ones(keys.shape[0], dtype=bool))
    assert int(st.n) == keys.shape[0] and t.rounds > 0
    assert t.residue_launches == 0 and int(t._kernel_rounds) == 0
    assert t.rounds == t._host_rounds
    t.init_state()
    assert t.rounds == t.residue_launches == 0


def test_stats_carry_the_residue_launches():
    from tsxcount_tpu_torch import KmerCounter

    c = KmerCounter(k=14, l=12, backend="table", batch_words=256,
                    device="cpu")
    c.add_reads(["ACGTTGCAAGGCTTACGATCGATCGGATCCA" * 4])
    c.finish()
    st = c.stats()
    assert st["table_residue_launches"] == 0 and st["table_rounds"] > 0
    assert list(st).index("table_residue_launches") == list(st).index(
        "table_inserts") + 1
