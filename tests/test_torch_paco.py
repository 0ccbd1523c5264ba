"""The port's PACO core (``repro_torch.core``) against ``repro.core`` on the
CPU, on the same numpy inputs: planners field for field, executors on the
same data, and ``launch.paco``.

Tolerances:
- integers are exact: plans, assignments, LCS lengths and borders, bucket
  sizes, sorted keys;
- float32 products (``paco_matmul``, Strassen): atol 1e-4, the bound of
  ``tests/test_paco_core.py`` (the two frameworks sum in other orders);
  bf16 ``paco_matmul``: 3e-2 of max(1, max |JAX|), since both round each
  k-cut's partial product to bf16 at other points;
- 1D: atol 1e-6 (the same float32 additions; minima are exact); GAP in
  float32 against JAX and against the float64 reference: atol 1e-5, as
  ``tests/test_paco_core.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.core import lcs as jlcs
from repro_torch import core as T
from repro_torch.core import lcs as tlcs
from repro_torch.launch import paco as launch_paco

torch.set_num_threads(1)


def _astuple(x):
    return dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x


# ---------------------------------------------------------------------------
# planners
# ---------------------------------------------------------------------------

def _binary_children(node):
    path, size = node
    return [(path + "L", size / 2), (path + "R", size / 2)]


@pytest.mark.parametrize("p,depth,gamma", [(1, 4, None), (3, 7, None),
                                           (5, 6, None), (7, 5, 2),
                                           (16, 7, None), (13, 6, 1)])
def test_pruned_bfs_matches_jax(p, depth, gamma):
    args = ([("", float(2 ** depth))], _binary_children,
            lambda n: n[1] <= 1.0, p)
    want = J.pruned_bfs(*args, arity=2, gamma=gamma)
    got = T.pruned_bfs(*args, arity=2, gamma=gamma)
    assert got.by_proc == want.by_proc
    assert (got.super_rounds, got.round_depths) == (want.super_rounds,
                                                    want.round_depths)
    work = lambda n: n[1]  # noqa: E731
    assert got.loads(work) == want.loads(work)
    assert got.imbalance(work) == want.imbalance(work)
    assert T.geometric_decrease_ok(got, work) == J.geometric_decrease_ok(
        want, work)


def _plan_fields(plan):
    return ((plan.n, plan.m, plan.k, plan.p, plan.kind),
            tuple((proc, _astuple(c)) for proc, c in plan.tiles),
            tuple(_astuple(c) for c in plan.cuts),
            plan.per_proc_volume(), plan.per_proc_surface(),
            plan.comm_bytes(), plan.k_cut_rounds(), plan.check_exact_cover())


@pytest.mark.parametrize("shape", [(96, 80, 64), (8192, 8192, 8192),
                                   (65536, 8192, 512), (7, 1, 300)])
@pytest.mark.parametrize("p", [1, 5, 12, 131, 132])
def test_mm_planners_match_jax(shape, p):
    n, m, k = shape
    assert _plan_fields(T.plan_mm_1piece(n, m, k, p)) == _plan_fields(
        J.plan_mm_1piece(n, m, k, p))
    base = max(1, min(n, m, k) // (4 * p))
    assert _plan_fields(T.plan_mm(n, m, k, p, base=base)) == _plan_fields(
        J.plan_mm(n, m, k, p, base=base))
    thr = list(np.random.default_rng(p).uniform(0.5, 4.0, p))
    assert _plan_fields(T.plan_hetero(n, m, k, thr)) == _plan_fields(
        J.plan_hetero(n, m, k, thr))


def test_plan_mm_const_pieces_matches_jax():
    for gamma in (1, 2, 3):
        assert _plan_fields(T.plan_mm(256, 128, 64, 7, gamma=gamma)) == \
            _plan_fields(J.plan_mm(256, 128, 64, 7, gamma=gamma))


@pytest.mark.parametrize("p", [1, 3, 5, 6, 7, 12, 30, 97, 128, 132])
def test_mesh_factors_and_megatron_bytes_match_jax(p):
    for shape in [(4096, 2048, 1024), (4096, 64, 64), (65536, 512, 512)]:
        assert T.mesh_factors(*shape, p) == J.mesh_factors(*shape, p)
        for shard in ("m", "k"):
            assert T.megatron_comm_bytes(*shape, p, shard=shard) == \
                J.megatron_comm_bytes(*shape, p, shard=shard)
    with pytest.raises(ValueError):
        T.mesh_factors(64, 64, 64, 0)


# ---------------------------------------------------------------------------
# matmul and Strassen
# ---------------------------------------------------------------------------

def _pair(seed, n, k, m):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)).astype(np.float32),
            rng.standard_normal((k, m)).astype(np.float32))


@pytest.mark.parametrize("p,shape", [(p, (96, 64, 80))
                                     for p in (1, 2, 3, 5, 7, 8, 12, 13)]
                         + [(132, (24, 16, 20))])
@pytest.mark.parametrize("planner", ["1piece", "mm"])
def test_paco_matmul_f32_matches_jax(p, shape, planner):
    """The p of tests/test_paco_core.py:143, and p = 132 at a small
    shape (many of its cuboids are empty)."""
    a, b = _pair(p, *shape)
    want = J.paco_matmul(jnp.asarray(a), jnp.asarray(b), p, planner=planner)
    got = T.paco_matmul(torch.from_numpy(a), torch.from_numpy(b), p,
                        planner=planner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("p", [4, 7])
def test_paco_matmul_hetero_matches_jax(p):
    a, b = _pair(p, 64, 64, 64)
    thr = [1.0 + i for i in range(p)]
    want = J.paco_matmul(jnp.asarray(a), jnp.asarray(b), p,
                         planner="hetero", throughputs=thr)
    got = T.paco_matmul(torch.from_numpy(a), torch.from_numpy(b), p,
                        planner="hetero", throughputs=thr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    with pytest.raises(ValueError):
        T.paco_matmul(torch.from_numpy(a), torch.from_numpy(b), p,
                      planner="hetero")


@pytest.mark.parametrize("p,shape", [(3, (96, 128, 80)), (13, (96, 128, 80)),
                                     (132, (24, 32, 20))])
@pytest.mark.parametrize("planner", ["1piece", "mm", "hetero"])
def test_paco_matmul_bf16_matches_jax(p, shape, planner):
    a, b = _pair(p, *shape)
    kw = {"planner": planner}
    if planner == "hetero":
        kw["throughputs"] = [1.0 + (i % 5) for i in range(p)]
    want = J.paco_matmul(jnp.asarray(a, jnp.bfloat16),
                         jnp.asarray(b, jnp.bfloat16), p, **kw)
    got = T.paco_matmul(torch.from_numpy(a).bfloat16(),
                        torch.from_numpy(b).bfloat16(), p, **kw)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=3e-2 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_strassen_matches_jax(depth):
    a, b = _pair(depth, 64, 64, 64)
    want = J.strassen(jnp.asarray(a), jnp.asarray(b), depth)
    got = T.strassen(torch.from_numpy(a), torch.from_numpy(b), depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("p", [1, 3, 7, 11, 50])
@pytest.mark.parametrize("depth", [1, 2])
def test_paco_strassen_matches_jax(p, depth):
    a, b = _pair(p + depth, 64, 64, 64)
    want = J.paco_strassen(jnp.asarray(a), jnp.asarray(b), p, depth=depth)
    got = T.paco_strassen(torch.from_numpy(a), torch.from_numpy(b), p,
                          depth=depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("p,base,gamma", [(1, 64, None), (5, 64, None),
                                          (49, 64, None), (50, 64, 2),
                                          (131, 256, None)])
def test_plan_strassen_matches_jax(p, base, gamma):
    want = J.plan_strassen(2 ** 12, p, base=base, gamma=gamma)
    got = T.plan_strassen(2 ** 12, p, base=base, gamma=gamma)
    assert [[_astuple(nd) for nd in procs] for procs in got.by_proc] == \
        [[_astuple(nd) for nd in procs] for procs in want.by_proc]
    assert got.round_depths == want.round_depths
    assert T.OMEGA0 == J.OMEGA0


@pytest.mark.parametrize("rates", [(197e12, 3.9e12), (989e12, 3.35e12 / 6),
                                   (67e12, 3.35e12 / 12), (1e12, 1e12)])
def test_strassen_beneficial_depth_matches_jax(rates):
    mm, adds = rates
    for n in (256, 2048, 8192, 65536, 2 ** 20):
        assert T.strassen_beneficial_depth(
            n, matmul_flops=mm, adds_per_s=adds) == \
            J.strassen_beneficial_depth(n, mxu_flops=mm, vpu_flops=adds)


# ---------------------------------------------------------------------------
# LCS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,p", [(256, 1), (256, 4), (256, 7), (512, 9),
                                 (64, 132)])
def test_partition_lcs_matches_jax(n, p):
    want = J.partition_lcs(n, p)
    got = T.partition_lcs(n, p)
    assert [_astuple(r) for r in got.regions] == [
        _astuple(r) for r in want.regions]
    assert got.partition_overhead() == want.partition_overhead()
    assert [r.antidiag() for r in got.regions] == [
        r.antidiag() for r in want.regions]


@pytest.mark.parametrize("seed,m,n,p,tile", [
    (0, 32, 32, 1, None), (1, 32, 32, 2, None), (2, 32, 32, 3, None),
    (3, 64, 64, 5, None), (4, 64, 64, 8, None), (5, 64, 96, 4, 16),
    (6, 96, 32, 2, 8), (7, 64, 64, 132, 8)])
def test_paco_lcs_and_reference_match_jax(seed, m, n, p, tile):
    rng = np.random.default_rng(seed)
    s, t = rng.integers(0, 4, m), rng.integers(0, 4, n)
    js, jt = jnp.asarray(s, jnp.int32), jnp.asarray(t, jnp.int32)
    ts, tt = torch.tensor(s, dtype=torch.int32), torch.tensor(
        t, dtype=torch.int32)
    want = int(J.lcs_reference(js, jt))
    assert int(T.lcs_reference(ts, tt)) == want
    assert int(J.paco_lcs(js, jt, p, tile=tile)) == want
    got = T.paco_lcs(ts, tt, p, tile=tile)
    assert got.dtype == torch.int32 and int(got) == want


def test_paco_lcs_rejects_a_tile_that_does_not_divide():
    s = torch.zeros(48, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not divide"):
        T.paco_lcs(s, s, 2, tile=32)


@pytest.mark.parametrize("tile,monotone", [(8, True), (16, True), (7, False),
                                           (33, False)])
def test_core_lcs_tile_matches_jax(tile, monotone):
    rng = np.random.default_rng(tile)
    s, t = rng.integers(0, 4, tile), rng.integers(0, 4, tile + 3)
    if monotone:
        top = np.sort(rng.integers(0, 3, tile + 3))
        left = np.sort(rng.integers(0, 3, tile))
        corner = min(top[0], left[0])
    else:
        top = rng.integers(-5, 9, tile + 3)
        left = rng.integers(-5, 9, tile)
        corner = rng.integers(-5, 9)
    args = [np.asarray(x, np.int32) for x in (s, t, top, left, corner)]
    want = jlcs.lcs_tile(*map(jnp.asarray, args))
    got = tlcs.lcs_tile(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# 1D and GAP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [2, 3, 5, 7, 12, 132])
def test_partition_square_matches_jax(p):
    for box in [(0, 512, 0, 512), (3, 40, 40, 200), (0, 9, 9, 10)]:
        assert [_astuple(r) for r in T.partition_square(*box,
                                                        tuple(range(p)))] \
            == [_astuple(r) for r in J.partition_square(*box,
                                                        tuple(range(p)))]


@pytest.mark.parametrize("seed,p,n", [(0, 1, 16), (1, 2, 16), (2, 3, 17),
                                      (3, 5, 32), (4, 8, 23), (5, 132, 32)])
def test_paco_onedim_matches_jax(seed, p, n):
    w = np.random.default_rng(seed).random((n + 1, n + 1)).astype(np.float32)
    want = np.asarray(J.paco_onedim(jnp.asarray(w), p))
    got = T.paco_onedim(torch.from_numpy(w), p).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(T.onedim_reference(torch.from_numpy(w)).numpy(),
                               np.asarray(J.onedim_reference(jnp.asarray(w))),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed,p,tile", [(0, 1, 4), (1, 2, 4), (2, 4, 4),
                                         (3, 3, None), (4, 132, 3)])
def test_paco_gap_matches_jax(seed, p, tile):
    rng = np.random.default_rng(seed)
    n = 12
    s, w, w2 = (rng.random((n + 1, n + 1)) for _ in range(3))
    want = np.asarray(J.paco_gap(*(jnp.asarray(x, jnp.float32)
                                   for x in (s, w, w2)), p, tile=tile))
    got = T.paco_gap(*(torch.tensor(x, dtype=torch.float32)
                       for x in (s, w, w2)), p, tile=tile)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), T.gap_reference(s, w, w2),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(T.gap_reference(s, w, w2),
                                  J.gap_reference(s, w, w2))


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2, 5, 13])
def test_paco_sort_matches_jax_for_the_same_pivots(p):
    x = np.random.default_rng(p).random(2048).astype(np.float32)
    key = jax.random.PRNGKey(p)
    want, want_sizes = J.paco_sort(jnp.asarray(x), p, key)
    pivots = np.asarray(J.choose_pivots(jnp.asarray(x), p, key))
    got, sizes = T.sort_by_pivots(torch.from_numpy(x),
                                  torch.tensor(pivots), p)
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.sort(x))


@pytest.mark.parametrize("p", [1, 3, 8, 132])
def test_paco_sort_exact_and_balanced(p):
    n = 2 ** 15
    x = torch.from_numpy(np.random.default_rng(p).random(n).astype(
        np.float32))
    gen = torch.Generator().manual_seed(p)
    got, sizes = T.paco_sort(x, p, gen)
    assert torch.equal(got, torch.sort(x).values)
    assert int(sizes.sum()) == n and sizes.shape == (p,)
    assert int(sizes.max()) <= 3.0 * n / p   # test_paco_core.py:297's eps
    pivots = T.choose_pivots(x, p, torch.Generator().manual_seed(p))
    assert pivots.shape == (p - 1,)
    assert torch.equal(pivots, torch.sort(pivots).values)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 5])
def test_launch_paco_on_cpu(p, capsys):
    assert launch_paco.main(["--device", "cpu", "--p", str(p)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == [
        "LCS", "1D/LWS", "GAP", "MM", "Strassen", "Sort"]
    assert all(line.endswith("[ok]") for line in out)


def test_launch_paco_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_paco.main(["--p", "3"])
