"""The port's two PACO kernels on the CPU: their plain versions and CPU
emulations of the CUDA kernels' walks against ``repro``'s Pallas kernels in
interpret mode (``matmul_pallas``, ``lcs_tile_pallas``) and against
``lcs_pallas``, on numpy inputs from a seed.

- ``emulate_matmul`` walks ``csrc/matmul.cu``: one 128 x 128 output tile
  per CTA, k in steps of 32 (bf16, each step two m16n8k16 tensor-core
  products of bf16 operands into f32) or 8 (float32, one FMA per k), loads
  zero-filled past the ragged edges, one f32 accumulator flushed once in
  ``a.dtype``.
- ``emulate_lcs_tiles`` walks ``csrc/lcs_tile.cu``: 8 columns per thread,
  a thread-local running max, a warp scan in the steps of
  ``__shfl_up_sync`` (1, 2, 4, 8, 16), a max over the earlier warps'
  totals, and the next row's diagonal from the neighbouring thread or, at
  a warp's first lane, from the left border and the warp prefix; int32
  sums wrap.

Tolerances: float32 atol 1e-4 and bf16 3e-2 against ``matmul_pallas``
(as ``tests/test_kernels.py``); against the port's plain version, within
``chip_smoke.py``'s MM_TOL of max(1, max |plain|): 1e-5 in float32 (sums
in other orders), 1e-2 in bf16 (one bf16 step where the two f32 sums
round to neighbours).  LCS is exact everywhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lcs_reference as jlcs_reference
from repro.kernels.lcs import lcs_pallas, lcs_tile_pallas
from repro.kernels.lcs import lcs_tile_ref as jlcs_tile_ref
from repro.kernels.matmul import matmul as jmatmul
from repro.kernels.matmul import matmul_pallas
from repro.kernels.matmul import matmul_ref as jmatmul_ref
from repro_torch.kernels.lcs import lcs as KL
from repro_torch.kernels.lcs import (lcs_tile_kernel, lcs_tile_ref,
                                     lcs_tiles_ref, lcs_wavefront)
from repro_torch.kernels.matmul import matmul, matmul_kernel, matmul_ref

torch.set_num_threads(1)
INT_MIN = -2 ** 31
MM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _rel(got, want):
    want = want.float()
    return ((got.float() - want).abs().max().item()
            / max(1.0, want.abs().max().item())) if want.numel() else 0.0


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

def _k_shift(a: torch.Tensor, b: torch.Tensor) -> int:
    """Where the bf16 walk starts k: at minus A's 16-byte phase in
    elements when both row strides are multiples of 8 (then every row of
    A has that phase), else at 0 (``matmul`` in ``csrc/matmul.cu``)."""
    strides = (a.stride(0) if a.shape[0] > 1 else 8,
               b.stride(0) if b.shape[0] > 1 else 8)
    if a.dtype != torch.bfloat16 or any(s % 8 for s in strides):
        return 0
    return (a.data_ptr() >> 1) & 7


def emulate_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The CTA walk of ``csrc/matmul.cu`` on the CPU.  (The bf16 kernel
    also shifts its output columns by B's phase; that moves no sum.)"""
    bf16 = a.dtype == torch.bfloat16
    bm = bn = 128
    bk = 32 if bf16 else 8
    n, k = a.shape
    m = b.shape[1]
    shift = _k_shift(a, b)
    a = torch.cat([torch.zeros((n, shift), dtype=a.dtype), a], dim=1)
    b = torch.cat([torch.zeros((shift, m), dtype=b.dtype), b], dim=0)
    out = torch.empty((n, m), dtype=a.dtype)
    for n0 in range(0, n, bm):
        for m0 in range(0, m, bn):
            acc = torch.zeros((bm, bn), dtype=torch.float32)
            for k0 in range(0, k + shift, bk):
                at = torch.zeros((bm, bk), dtype=a.dtype)
                bt = torch.zeros((bk, bn), dtype=a.dtype)
                blk = a[n0:n0 + bm, k0:k0 + bk]
                at[:blk.shape[0], :blk.shape[1]] = blk
                blk = b[k0:k0 + bk, m0:m0 + bn]
                bt[:blk.shape[0], :blk.shape[1]] = blk
                at, bt = at.float(), bt.float()
                step = 16 if bf16 else 1   # one mma, or one FMA per k
                for kk in range(0, bk, step):
                    acc += at[:, kk:kk + step] @ bt[kk:kk + step]
            tile = out[n0:n0 + bm, m0:m0 + bn]
            tile.copy_(acc[:tile.shape[0], :tile.shape[1]].to(a.dtype))
    return out


def _operands(seed, n, k, m, dtype):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, k)).astype(np.float32)
    b = rng.standard_normal((k, m)).astype(np.float32)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (jnp.asarray(a, jd), jnp.asarray(b, jd),
            torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype))


@pytest.mark.parametrize("shape", [(64, 64, 64), (128, 96, 64),
                                   (256, 128, 32), (32, 256, 128),
                                   (128, 128, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_walk_matches_pallas_and_plain(shape, dtype):
    """The shapes of tests/test_kernels.py:22-52."""
    n, k, m = shape
    ja, jb, ta, tb = _operands(0, n, k, m, dtype)
    want = np.asarray(matmul_pallas(ja, jb, bn=32, bm=32, bk=32,
                                    interpret=True), np.float32)
    got = emulate_matmul(ta, tb)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    assert _rel(got, matmul_ref(ta, tb)) <= MM_TOL[dtype]
    np.testing.assert_allclose(matmul_ref(ta, tb).float().numpy(),
                               np.asarray(jmatmul_ref(ja, jb), np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(1, 1, 1), (17, 23, 31), (97, 131, 61),
                                   (129, 7, 257), (130, 40, 3), (5, 0, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_walk_on_ragged_shapes(shape, dtype):
    """Shapes no block in (128, 64, 32, 16, 8) divides: JAX's ops.matmul
    falls back to jnp.dot there, the kernel masks the ragged edges."""
    n, k, m = shape
    ja, jb, ta, tb = _operands(1, n, k, m, dtype)
    got = emulate_matmul(ta, tb)
    assert got.dtype == dtype and got.shape == (n, m)
    assert _rel(got, matmul_ref(ta, tb)) <= MM_TOL[dtype]
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(
        matmul(ta, tb).float().numpy(),
        np.asarray(jmatmul(ja, jb, interpret=True), np.float32),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_walk_on_strided_views(dtype):
    """A cuboid's faces are views with a row stride; the walk reads them
    in place and agrees with the plain version on contiguous copies."""
    _, _, big_a, big_b = _operands(2, 300, 264, 280, dtype)
    _, _, odd, _ = _operands(3, 40, 61, 1, dtype)
    shifts = set()
    for a, b in [(big_a[3:200, 7:190], big_b[5:188, 11:270]),
                 (big_a[::2, 8:136], big_b[8:136, 128:257]),
                 (big_a[1:2, :], big_b[:, 279:280]),
                 (big_a[:, 5:], big_b[5:, :]), (big_a[:, 3:], big_b[3:, :]),
                 (odd[:, 2:], big_b[:59, 3:12])]:
        shifts.add(_k_shift(a, b))
        want = matmul_ref(a.contiguous(), b.contiguous())
        assert _rel(emulate_matmul(a, b), want) <= MM_TOL[dtype]
        assert torch.equal(matmul_kernel(a, b), want)  # CPU: plain version
    if dtype == torch.bfloat16:   # phases of the views of big_a; odd's
        assert shifts == {7, 0, 5, 3}  # row stride 61 gathers every chunk


# ---------------------------------------------------------------------------
# LCS
# ---------------------------------------------------------------------------

def _shift(x: torch.Tensor, by: int, fill: torch.Tensor) -> torch.Tensor:
    """x moved ``by`` places up the last axis, ``fill`` below (the lanes
    that __shfl_up_sync leaves unchanged and the guard ignores)."""
    return torch.cat([fill.expand(*x.shape[:-1], by), x[..., :-by]], dim=-1)


def emulate_lcs_tiles(s_tiles, t_tiles, top, left, corner, run: int = 8):
    """The per-CTA walk of ``csrc/lcs_tile.cu`` for T tiles at once."""
    n_t, m = s_tiles.shape
    n = t_tiles.shape[1]
    runs = -(-n // run)
    threads = -(-runs // 32) * 32
    warps, width = threads // 32, threads * run
    lo = torch.tensor(INT_MIN, dtype=torch.int32)
    pad = lambda x: torch.cat(  # noqa: E731
        [x, lo.expand(n_t, width - n)], dim=1).view(n_t, threads, run)
    tv = pad(t_tiles)
    prev = pad(top)
    c0 = torch.arange(threads) * run
    top_x = torch.cat([top, lo.expand(n_t, width - n + 1)], dim=1)
    diag0 = torch.where(c0 == 0, corner[:, None],
                        top_x[:, (c0 - 1).clamp(min=0)])
    diag0 = torch.where(c0 <= n, diag0, lo)
    rights = []
    for i in range(m):
        si, li = s_tiles[:, i, None, None], left[:, i]
        dg, run_max, loc = diag0, lo.expand(n_t, threads), []
        for r in range(run):
            a = torch.maximum(prev[:, :, r],
                              dg + (tv[:, :, r] == si[:, :, 0]).int())
            dg = prev[:, :, r]
            run_max = torch.maximum(run_max, a)
            loc.append(run_max)
        loc = torch.stack(loc, dim=2)
        incl = run_max.reshape(n_t, warps, 32)
        for o in (1, 2, 4, 8, 16):
            incl = torch.maximum(incl, _shift(incl, o, lo))
        excl = _shift(incl, 1, lo)
        totals = incl[:, :, 31]
        wpre = torch.cat([lo.expand(n_t, 1),
                          torch.cummax(totals, dim=1).values[:, :-1]], dim=1)
        pre = torch.maximum(torch.maximum(li[:, None, None],
                                          wpre[:, :, None]), excl)
        prev = torch.maximum(loc, pre.reshape(n_t, threads, 1))
        rights.append(prev.reshape(n_t, width)[:, n - 1])
        up = _shift(prev[:, :, run - 1], 1, lo)
        lane0 = torch.maximum(li[:, None], wpre).repeat_interleave(32, dim=1)
        diag0 = torch.where(torch.arange(threads) % 32 == 0, lane0, up)
    return prev.reshape(n_t, width)[:, :n], torch.stack(rights, dim=1)


def _borders(rng, n_t, m, n, kind):
    ints = lambda *shape: rng.integers(0, 4, shape)  # noqa: E731
    s, t = ints(n_t, m), ints(n_t, n)
    if kind == "monotone":   # as tests/test_kernels.py:114 draws them
        top = np.sort(rng.integers(0, 3, (n_t, n)), axis=1)
        left = np.sort(rng.integers(0, 3, (n_t, m)), axis=1)
        corner = np.minimum(top[:, 0], left[:, 0])
    else:                    # any int32, the extremes included
        hi = 2 ** 31 - 1
        top = rng.integers(-hi - 1, hi, (n_t, n), endpoint=True)
        left = rng.integers(-hi - 1, hi, (n_t, m), endpoint=True)
        corner = rng.integers(-hi - 1, hi, n_t, endpoint=True)
        top[:, ::7], left[:, ::5] = hi, hi   # sums that wrap
    return [np.asarray(x, np.int32) for x in (s, t, top, left, corner)]


@pytest.mark.parametrize("m,n", [(8, 8), (16, 16), (32, 32), (5, 7),
                                 (1, 1), (16, 300), (9, 520)])
@pytest.mark.parametrize("kind", ["monotone", "any"])
def test_lcs_walk_matches_pallas_and_plain(m, n, kind):
    """One tile against lcs_tile_pallas in interpret mode: the tiles of
    tests/test_kernels.py:114, ragged ones, and tiles wide enough for
    several warps, on DP borders and on arbitrary int32 ones."""
    rng = np.random.default_rng(m * 1000 + n)
    s, t, top, left, corner = _borders(rng, 1, m, n, kind)
    want_b, want_r = lcs_tile_pallas(
        jnp.asarray(s[0]), jnp.asarray(t[0]), jnp.asarray(top[0]),
        jnp.asarray(left[0]), jnp.asarray(corner), interpret=True)
    ts = [torch.from_numpy(x) for x in (s, t, top, left, corner)]
    for got_b, got_r in (emulate_lcs_tiles(*ts),
                         lcs_tiles_ref(*ts),
                         [x[None] for x in lcs_tile_ref(
                             *(x[0] for x in ts[:4]), ts[4])],
                         [x[None] for x in lcs_tile_kernel(
                             *(x[0] for x in ts[:4]), ts[4])]):
        np.testing.assert_array_equal(got_b[0].numpy(), np.asarray(want_b))
        np.testing.assert_array_equal(got_r[0].numpy(), np.asarray(want_r))


@pytest.mark.parametrize("n_t,m,n", [(5, 16, 16), (3, 7, 40), (4, 33, 260)])
@pytest.mark.parametrize("kind", ["monotone", "any"])
def test_lcs_batched_walk_matches_jax_per_tile(n_t, m, n, kind):
    """T > 1 tiles at once (one anti-diagonal): the batched plain version
    and the walk against JAX's plain version tile by tile."""
    rng = np.random.default_rng(n_t + m + n)
    s, t, top, left, corner = _borders(rng, n_t, m, n, kind)
    ts = [torch.from_numpy(x) for x in (s, t, top, left, corner)]
    walk_b, walk_r = emulate_lcs_tiles(*ts)
    ref_b, ref_r = lcs_tiles_ref(*ts)
    assert torch.equal(walk_b, ref_b) and torch.equal(walk_r, ref_r)
    for i in range(n_t):
        want_b, want_r = jlcs_tile_ref(
            jnp.asarray(s[i]), jnp.asarray(t[i]), jnp.asarray(top[i]),
            jnp.asarray(left[i]), jnp.asarray(corner[i:i + 1]))
        np.testing.assert_array_equal(ref_b[i].numpy(), np.asarray(want_b))
        np.testing.assert_array_equal(ref_r[i].numpy(), np.asarray(want_r))


@pytest.mark.parametrize("n,p,tile", [(64, 2, None), (64, 4, None),
                                      (128, 3, None), (96, 1, 32),
                                      (60, 5, 12)])
def test_wavefront_matches_lcs_pallas(n, p, tile):
    """The port's one-launch-per-diagonal wavefront (its border arrays in
    two halves) against lcs_pallas's per-tile loop and the reference."""
    rng = np.random.default_rng(n + p)
    s, t = rng.integers(0, 4, n), rng.integers(0, 4, n)
    js, jt = jnp.asarray(s, jnp.int32), jnp.asarray(t, jnp.int32)
    want = int(jlcs_reference(js, jt))
    if n % 8 == 0 and tile is None:
        assert int(lcs_pallas(js, jt, p, interpret=True)) == want
    ts, tt = (torch.tensor(x, dtype=torch.int32) for x in (s, t))
    launches = KL.lcs_diagonal_kernel.launches
    assert int(lcs_wavefront(ts, tt, p, tile=tile)) == want
    assert KL.lcs_diagonal_kernel.launches == launches  # CPU: plain version


def test_wavefront_diagonals_through_the_walk(monkeypatch):
    """Each anti-diagonal's tiles through the walk emulation, in the
    kernel's border layout: the table's LCS comes out exact, with one
    call per diagonal (ti + tj - 1)."""
    calls = []

    def walk(*tiles):
        calls.append(tiles[0].shape[0])
        return emulate_lcs_tiles(*tiles)

    monkeypatch.setattr(KL, "lcs_tiles_ref", walk)
    rng = np.random.default_rng(7)
    s, t = rng.integers(0, 4, 96), rng.integers(0, 4, 64)
    want = int(jlcs_reference(jnp.asarray(s, jnp.int32),
                              jnp.asarray(t, jnp.int32)))
    got = lcs_wavefront(torch.tensor(s, dtype=torch.int32),
                        torch.tensor(t, dtype=torch.int32), 4, tile=16)
    assert int(got) == want
    assert calls == [1, 2, 3, 4, 4, 4, 3, 2, 1]


def test_lcs_tile_column_chunks_chain_exactly(monkeypatch):
    """A tile wider than the kernel's widest goes through in column
    chunks (the right column of one is the next one's left border, its
    top entry one column left the next corner): exact on any borders."""
    monkeypatch.setattr(KL, "_chunk_width", lambda x: 5)
    rng = np.random.default_rng(3)
    for kind in ("monotone", "any"):
        s, t, top, left, corner = (torch.from_numpy(x[0] if x.ndim > 1
                                                    else x)
                                   for x in _borders(rng, 1, 9, 23, kind))
        got = lcs_tile_kernel(s, t, top, left, corner)
        want = lcs_tile_ref(s, t, top, left, corner)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_lcs_wrappers_reject_what_they_do_not_take():
    s = torch.zeros(8, dtype=torch.int32)
    rows = torch.zeros((2, 8), dtype=torch.int32)
    corners = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not cut"):
        KL.lcs_diagonal_kernel(s, s, rows, rows, corners, 0, 3, 8)
    with pytest.raises(ValueError, match="outside"):
        KL.lcs_diagonal_kernel(s, s, rows, rows, corners, 1, 8, 8)
    with pytest.raises(TypeError, match="int32"):
        KL.lcs_diagonal_kernel(s.long(), s, rows, rows, corners, 0, 8, 8)
    with pytest.raises(ValueError, match="shape"):
        KL.lcs_diagonal_kernel(s, s, rows[:1], rows, corners, 0, 8, 8)
    with pytest.raises(ValueError, match="M, N >= 1"):
        lcs_tile_kernel(s[:0], s, s, s[:0], s[:1])
