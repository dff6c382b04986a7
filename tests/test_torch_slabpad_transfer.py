"""The slab-pad plan's put and get across processes
(``parallel/slabpad.py``): a put stages only the real rows of its
process's parts and lays them out on the device, a get gathers every
process's real rows and hands each process the whole logical vector.

One, two and four processes over gloo on the CPU
(``tests/test_torch_multiproc_worker.py``'s task ``slabio``, one spawn per
count) each hold their share of four slabs of 6 layers, the last one 3,
so the processes own uneven counts of rows.  The file imports neither JAX
nor the JAX package.
"""

import numpy as np
import pytest

from test_torch_multiproc_worker import spawn

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {w: spawn("slabio", tmp_path_factory.mktemp(f"slabio{w}"),
                     world=w) for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_each_process_owns_its_rows(runs, world):
    """The processes' rows tile the vector in rank order; the last process
    owns the short slab."""
    rs = runs[world]
    assert [int(r["local_parts"]) for r in rs] == [4 // world] * world
    rows = [tuple(int(v) for v in r["rows"]) for r in rs]
    n = rs[0]["x"].size
    assert rows[0][0] == 0 and rows[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    layer = n // 21
    assert rows[-1][1] - rows[-1][0] == (3 + 6 * (4 // world - 1)) * layer


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("world", WORLDS)
def test_put_equals_the_local_scatter_bit_for_bit(runs, world, dtype):
    """Pad slots and dead layers included: the same bytes as this
    process's rows of the host scatter."""
    for r in runs[world]:
        put, ref = r[f"put_{dtype}"], r[f"scatter_{dtype}"]
        assert put.dtype == ref.dtype == np.dtype(dtype)
        assert put.shape == ref.shape == (int(r["local_parts"]), ref.shape[1])
        assert put.tobytes() == ref.tobytes()


@pytest.mark.parametrize("world", WORLDS)
def test_put_reads_only_its_own_rows(runs, world):
    """NaN in every row outside the process's layers leaves its slabs
    finite and equal to the put of the whole vector."""
    for r in runs[world]:
        assert np.isfinite(r["nan_put"]).all()
        assert r["nan_put"].tobytes() == r["put_float64"].tobytes()


@pytest.mark.parametrize("world", WORLDS)
def test_gather_hands_every_process_a_new_whole_vector(runs, world):
    """Every process gets the whole logical vector, the input bit for bit,
    in an array it owns: writing into it changes neither the slabs nor a
    later gather."""
    for r in runs[world]:
        assert r["first_owns"] and not r["first_shares"]
        np.testing.assert_array_equal(r["first"], r["x"])
        np.testing.assert_array_equal(r["again"], r["x"])
        assert r["put_after"].tobytes() == r["put_float64"].tobytes()
