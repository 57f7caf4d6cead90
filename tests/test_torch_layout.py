"""The port's host-side layout against the JAX package's, byte for byte.

Packing, schedules, epoch streams, step sizes and synthetic data are numpy
on both sides, so every array must match exactly (``tol.assert_bitwise``).
Inputs come from the seeded builders in ``tests/strategies.py``.
"""
import dataclasses

import numpy as np
import pytest

import tolerance as tol
from strategies import coo_problem, drawn_schedule

from repro.core import partition as rpart
from repro.core import schedule as rsched
from repro.core.stepsize import PowerSchedule as RPower
from repro.data import synthetic as rsyn

from repro_torch.core import partition as tpart
from repro_torch.core import schedule as tsched
from repro_torch.core.stepsize import PowerSchedule as TPower
from repro_torch.data import synthetic as tsyn

#: (seed, p, m, n, nnz) — shapes drawn from strategies.PACK_SHAPE's ranges
SHAPES = [(0, 1, 4, 4, 1), (1, 3, 20, 12, 150), (2, 4, 50, 30, 400),
          (3, 6, 37, 9, 260), (4, 5, 12, 30, 90)]


def _array_fields(br):
    out = {f.name: getattr(br, f.name) for f in dataclasses.fields(br)}
    out["gid"] = br.gid
    return out


def assert_same_pack(a, b):
    fa, fb = _array_fields(a), _array_fields(b)
    assert fa.keys() == fb.keys()
    for name in fa:
        x, y = fa[name], fb[name]
        if name == "schedule":
            tol.assert_bitwise(x.table, y.table, "schedule.table")
            tol.assert_bitwise(x.active, y.active, "schedule.active")
            assert x.name == y.name
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            tol.assert_bitwise(x, y, name)
        else:
            assert x == y, name


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("schedule", ["ring", "random", "balanced"])
@pytest.mark.parametrize("waves", [True, False])
def test_pack_bitwise(shape, schedule, waves):
    seed, p, m, n, nnz = shape
    rows, cols, vals = coo_problem(seed, m, n, nnz)
    kw = dict(waves=waves, schedule=schedule, schedule_seed=seed)
    assert_same_pack(tpart.pack(rows, cols, vals, m, n, p, **kw),
                     rpart.pack(rows, cols, vals, m, n, p, **kw))


@pytest.mark.parametrize("shape", SHAPES[1:4])
@pytest.mark.parametrize("waves", [True, False])
def test_pack_sub_blocks_and_pins_bitwise(shape, waves):
    seed, p, m, n, nnz = shape
    rows, cols, vals = coo_problem(seed, m, n, nnz)
    rng = np.random.default_rng(seed)
    kw = dict(waves=waves, sub_blocks=2, balanced=False,
              row_owner=rng.integers(0, p, m), col_block=rng.integers(0, p, n))
    assert_same_pack(tpart.pack(rows, cols, vals, m, n, p, **kw),
                     rpart.pack(rows, cols, vals, m, n, p, **kw))


@pytest.mark.parametrize("pack", [tpart.pack, rpart.pack])
def test_pack_rejects_more_sub_blocks_than_columns(pack):
    # the shape PACK_SHAPE can draw (p=2, n=4 -> n_local=2, sub=3):
    # rejected by design on both sides
    rows, cols, vals = coo_problem(0, 4, 4, 1)
    with pytest.raises(ValueError, match="sub_blocks=3 > n_local=2"):
        pack(rows, cols, vals, 4, 4, 2, waves=True, sub_blocks=3)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("schedule", ["ring", "random", "balanced"])
def test_epoch_stream_and_step_major_bitwise(shape, schedule):
    seed, p, m, n, nnz = shape
    rows, cols, vals = coo_problem(seed, m, n, nnz)
    bt = tpart.pack(rows, cols, vals, m, n, p, schedule=schedule)
    br = rpart.pack(rows, cols, vals, m, n, p, schedule=schedule)
    for a, b in zip(tpart.epoch_stream(bt), rpart.epoch_stream(br)):
        tol.assert_bitwise(a, b, "epoch_stream")
    src = (bt.wave_rows, bt.wave_cols, bt.wave_vals, bt.wave_mask)
    for a, b in zip(tpart.step_major_cells(src),
                    rpart.step_major_cells(src)):
        tol.assert_bitwise(a, b, "step_major_cells")
    tol.assert_bitwise(bt.schedule_order(), br.schedule_order(),
                       "schedule_order")


@pytest.mark.parametrize("shape", SHAPES)
def test_shard_roundtrip_and_bitwise(shape):
    seed, p, m, n, nnz = shape
    rows, cols, vals = coo_problem(seed, m, n, nnz)
    br = tpart.pack(rows, cols, vals, m, n, p)
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(m, 5)).astype(np.float32)
    H = rng.normal(size=(n, 5)).astype(np.float32)
    Ws, Hs = tpart.shard_factors(W, H, br)
    for a, b in zip((Ws, Hs), rpart.shard_factors(W, H, br)):
        tol.assert_bitwise(a, b, "shard_factors")
    W2, H2 = tpart.unshard_factors(Ws, Hs, br)
    tol.assert_bitwise(W2, W, "W round trip")
    tol.assert_bitwise(H2, H, "H round trip")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k", [4, 8, 100])
def test_pack_cell_waves_bitwise(seed, k):
    rng = np.random.default_rng(seed)
    nnz = int(rng.integers(1, 300))
    r = rng.integers(0, 20, nnz)
    c = rng.integers(0, 10, nnz)
    v = rng.normal(size=nnz)
    for a, b in zip(tpart.pack_cell_waves(r, c, v),
                    rpart.pack_cell_waves(r, c, v)):
        tol.assert_bitwise(a, b, "pack_cell_waves")


@pytest.mark.parametrize("p", [1, 2, 3, 5, 6])
@pytest.mark.parametrize("spec", ["ring", "random", "balanced", "drawn"])
def test_schedules_bitwise(p, spec):
    seed = 7 * p
    if spec == "drawn":
        ref = drawn_schedule(seed, p)
        cells = [(q, b) for q in range(p) for b in range(p)]
        order = np.random.default_rng((seed, 0x5CED)).permutation(len(cells))
        port = tsched.OwnershipSchedule.from_visits(
            p, [cells[i] for i in order])
    else:
        loads = np.random.default_rng(seed).integers(0, 50, (p, p))
        port = tsched.OwnershipSchedule.resolve(spec, p, seed=seed,
                                                loads=loads)
        ref = rsched.OwnershipSchedule.resolve(spec, p, seed=seed,
                                               loads=loads)
    tol.assert_bitwise(port.table, ref.table, "table")
    tol.assert_bitwise(port.active, ref.active, "active")
    tol.assert_bitwise(port.perm_sources(), ref.perm_sources(),
                       "perm_sources")
    ea, eb = port.entry_sources(), ref.entry_sources()
    assert (ea is None) == (eb is None)
    if ea is not None:
        tol.assert_bitwise(ea, eb, "entry_sources")
    assert port.is_ring == ref.is_ring


@pytest.mark.parametrize("p", [2, 4, 6])
def test_topology_aware_schedule_bitwise(p):
    from repro.core.topology import HierarchicalMesh as RMesh
    from repro_torch.core.topology import HierarchicalMesh as TMesh
    loads = np.random.default_rng(p).integers(0, 30, (p, p))
    kw = dict(p=p, workers_per_node=2, intra_latency=1.0,
              inter_latency=8.0, intra_cost=1.0, inter_cost=6.0)
    for net in (None, "mesh"):
        port = tsched.OwnershipSchedule.topology_aware(
            p, seed=p, loads=loads, net=net and TMesh(**kw), block_size=3.0)
        ref = rsched.OwnershipSchedule.topology_aware(
            p, seed=p, loads=loads, net=net and RMesh(**kw), block_size=3.0)
        tol.assert_bitwise(port.table, ref.table, "topology table")
        tol.assert_bitwise(port.active, ref.active, "topology active")


def test_greedy_helpers_bitwise():
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, 9, 200), rng.integers(0, 7, 200)
    tol.assert_bitwise(tsched.greedy_two_resource_color(a, b, 9, 7),
                       rsched.greedy_two_resource_color(a, b, 9, 7), "color")
    w = rng.integers(0, 40, 50)
    tol.assert_bitwise(tsched.greedy_fill(np.zeros(4), w),
                       rsched.greedy_fill(np.zeros(4), w), "greedy_fill")


@pytest.mark.parametrize("alpha,beta,start,count",
                         [(0.012, 0.05, 0, 10), (0.096, 0.05, 7, 5),
                          (0.001, 0.0, 3, 4)])
def test_power_schedule_values_equal(alpha, beta, start, count):
    tol.assert_bitwise(TPower(alpha, beta).values(start, count),
                       RPower(alpha, beta).values(start, count), "values")
    assert TPower(alpha, beta)(start) == RPower(alpha, beta)(start)


@pytest.mark.parametrize("powerlaw", [True, False])
def test_synthetic_ratings_and_split_equal(powerlaw):
    a = tsyn.synthetic_ratings(120, 60, 3000, k=8, seed=3, noise=0.02,
                               powerlaw=powerlaw)
    b = rsyn.synthetic_ratings(120, 60, 3000, k=8, seed=3, noise=0.02,
                               powerlaw=powerlaw)
    for x, y in zip(a, b):
        tol.assert_bitwise(x, y, "synthetic_ratings")
    for x, y in zip(tsyn.train_test_split(*a[:3], test_frac=0.2, seed=1),
                    rsyn.train_test_split(*b[:3], test_frac=0.2, seed=1)):
        for u, v in zip(x, y):
            tol.assert_bitwise(u, v, "train_test_split")
