"""The port's two PACO kernels on the CPU: their plain versions and CPU
emulations of the CUDA kernels' walks against ``repro``'s Pallas kernels in
interpret mode (``matmul_pallas``, ``lcs_tile_pallas``) and against
``lcs_pallas``, on numpy inputs from a seed.

- ``emulate_matmul`` walks ``csrc/matmul.cu``: one 128 x 128 output tile
  per CTA, k in steps of 32, loads zero-filled past the ragged edges; bf16:
  each step two m16n8k16 tensor-core products of bf16 operands into one
  f32 accumulator flushed once in bf16; float32 (``wgmma_tf32x3``): each
  operand split into TF32 hi and lo parts (``tf32_split``: round to
  nearest, ties away, by int32 bit operations), per k8 slice A_lo B_hi +
  A_hi B_lo + A_hi B_hi into an accumulator that TF32X3_PROMOTE steps fill
  from zero before it is added into the tile's f32 total.  ``test_one_tf32_pass_fails_mm_tol_and_three_pass`` shows
  why three products: one errs past MM_TOL.
- ``emulate_skewed_sweep`` walks a tile of ``csrc/lcs_tile.cu``: runs of
  4 or 8 columns a lane, row r at lane k's step r + k, the left neighbour
  by ``__shfl_up_sync``, strips of 32 lanes pipelined through the
  hand-off ring and its mbarrier phases (warps stepping in a seeded random
  order), one three-way max over a wrapping add a cell; int32 sums wrap.
- ``test_claim_schedule_in_random_order_is_exact`` walks the launch's
  schedule: tiles claimed in anti-diagonal order, started once their
  neighbours' flags are set and finished in a seeded random order, over
  the kernel's single border buffers.

Tolerances: float32 atol 1e-4 and bf16 3e-2 against ``matmul_pallas``
(as ``tests/test_kernels.py``); against the port's plain version, within
``chip_smoke.py``'s MM_TOL of max(1, max |plain|): 1e-5 in float32 (sums
in other orders), 1e-2 in bf16 (one bf16 step where the two f32 sums
round to neighbours).  LCS is exact everywhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as JC
from repro.core import lcs_reference as jlcs_reference
from repro.kernels.lcs import lcs_pallas, lcs_tile_pallas
from repro.kernels.lcs import lcs_tile_ref as jlcs_tile_ref
from repro.kernels.matmul import matmul as jmatmul
from repro.kernels.matmul import matmul_pallas
from repro.kernels.matmul import matmul_ref as jmatmul_ref
from repro_torch.kernels.lcs import lcs as KL
from repro_torch.kernels.lcs import (lcs_tile_kernel, lcs_tile_ref,
                                     lcs_tiles_ref, lcs_wavefront)
import repro_torch.core as TC
import repro_torch.core.matmul as TCM
from repro_torch.kernels.matmul import (matmul, matmul_kernel,
                                        matmul_plan_kernel, matmul_plan_ref,
                                        matmul_ref)
from repro_torch.kernels.matmul.matmul import (PLAN_CELL, PLAN_COL_ALIGN,
                                               PLAN_TILES, plan_table)
from tf32_parts import tf32_round, tf32_split

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


TF32X3_PROMOTE = 4   # k-steps of 32 that wgmma sums before the f32 total


def _tf32x3_walk(steps, passes: int = 3) -> torch.Tensor:
    """The ``wgmma_tf32x3`` walk's sum over its k-steps, f32 boxes (at, bt)
    of (rows x 32) and (32 x cols): per k8 slice A_lo B_hi, A_hi B_lo and
    A_hi B_hi (``passes`` 1: A_hi B_hi alone) into wgmma's accumulator,
    which TF32X3_PROMOTE steps fill from zero before it is added into the
    f32 total."""
    total = acc = None
    for i, (at, bt) in enumerate(steps):
        if i % TF32X3_PROMOTE == 0:
            total = acc if total is None else total + acc
            acc = torch.zeros((at.shape[0], bt.shape[1]))
        ahi, alo = tf32_split(at)
        bhi, blo = tf32_split(bt)
        for kk in range(0, at.shape[1], 8):
            s = slice(kk, kk + 8)
            if passes == 3:
                acc += alo[:, s] @ bhi[s]
                acc += ahi[:, s] @ blo[s]
            acc += ahi[:, s] @ bhi[s]
    return acc if total is None else total + acc


def emulate_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The CTA walk of ``csrc/matmul.cu`` on the CPU.  (The bf16 kernel
    also shifts its output columns by B's phase; that moves no sum.)"""
    bf16 = a.dtype == torch.bfloat16
    bm = bn = 128
    bk = 32
    n, k = a.shape
    m = b.shape[1]
    shift = _k_shift(a, b)
    a = torch.cat([torch.zeros((n, shift), dtype=a.dtype), a], dim=1)
    b = torch.cat([torch.zeros((shift, m), dtype=b.dtype), b], dim=0)
    out = torch.empty((n, m), dtype=a.dtype)
    for n0 in range(0, n, bm):
        for m0 in range(0, m, bn):
            boxes = [(_boxed(a, n0, k0, bm, bk).float(),
                      _boxed(b, k0, m0, bk, bn).float())
                     for k0 in range(0, k + shift, bk)]
            if not bf16:   # wgmma_tf32x3
                acc = _tf32x3_walk(boxes) if boxes else torch.zeros((bm, bn))
            else:
                acc = torch.zeros((bm, bn), dtype=torch.float32)
                for at, bt in boxes:
                    for kk in range(0, bk, 16):   # one mma.sync each
                        acc += at[:, kk:kk + 16] @ bt[kk:kk + 16]
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
# matmul_plan: a whole PACO plan in one launch
# ---------------------------------------------------------------------------

# Plans with k-cuts (output shared by 2 to 4 cuboids, rectangles equal or
# overlapping in part), planners with several cuboids per processor, and
# one without k-cuts.
PLAN_CASES = [((64, 64, 64), 5, "1piece"), ((64, 64, 64), 7, "1piece"),
              ((64, 64, 64), 13, "1piece"), ((61, 67, 97), 12, "1piece"),
              ((64, 64, 64), 5, "mm"), ((96, 80, 64), 6, "hetero"),
              ((300, 260, 20), 4, "1piece"), ((128, 128, 128), 8, "1piece")]


_JAX_PLANS: dict = {}
# one compile per plan rather than one per slice and add
_jpaco_matmul = jax.jit(JC.paco_matmul, static_argnums=(2,),
                        static_argnames=("planner", "throughputs"))


def _plan(shape, p, planner):
    n, k, m = shape
    return TCM.plan(n, m, k, p, planner,
                          [1.0 + i % 3 for i in range(p)]
                          if planner == "hetero" else None)


def _boxed(x: torch.Tensor, r0: int, c0: int, rows: int, cols: int
           ) -> torch.Tensor:
    """x[r0:r0 + rows, c0:c0 + cols], zero past x's edges (a TMA box)."""
    out = torch.zeros((rows, cols), dtype=x.dtype)
    blk = x[r0:r0 + rows, c0:c0 + cols]
    out[:blk.shape[0], :blk.shape[1]] = blk
    return out


def _tile_part(a, b, q, r0, c0, variant):
    """One output tile's f32 sums as the variant's k-walk takes them: rows
    r0.., columns c0.. of cuboid q = (n0, n1, m0, m1, k0, k1) (c0 < 0 for
    wgmma's first tile column when m0 is not a multiple of 8)."""
    n0, n1, m0, m1, k0, k1 = q
    bm, bn = PLAN_TILES[variant]
    acc = torch.zeros((bm, bn))
    if variant == "wgmma_tf32x3":   # TMA boxes from k0 & ~3, 32 a step
        steps = []
        for kb in range(k0 - k0 % 4, k1, 32):
            at = _boxed(a, n0 + r0, kb, bm, 32)
            at[:, :max(k0 - kb, 0)] = 0      # A's columns before k0
            at[:, k1 - kb:] = 0              # ... and at and past k1
            steps.append((at, _boxed(b, kb, m0 + c0, 32, bn)))
        return _tf32x3_walk(steps)
    if variant == "wgmma":   # TMA boxes of the whole operands from k0 & ~7
        for kb in range(k0 - k0 % 8, k1, 64):
            at = _boxed(a, n0 + r0, kb, bm, 64).float()
            at[:, :max(k0 - kb, 0)] = 0      # A's columns before k0
            at[:, k1 - kb:] = 0              # ... and at and past k1
            bt = _boxed(b, kb, m0 + c0, 64, bn).float()
            for kk in range(0, 64, 16):
                acc += at[:, kk:kk + 16] @ bt[kk:kk + 16]
        return acc
    fa, fb = a[n0:n1, k0:k1], b[k0:k1, m0:m1]   # the faces, zero-filled
    bk, step = (32, 16) if variant == "mma_sync" else (8, 1)
    for kb in range(0, k1 - k0, bk):
        at = _boxed(fa, r0, kb, bm, bk).float()
        bt = _boxed(fb, kb, c0, bk, bn).float()
        for kk in range(0, bk, step):
            acc += at[:, kk:kk + step] @ bt[kk:kk + step]
    return acc


def emulate_matmul_plan(a, b, plan, variant, parts=None):
    """The two launches of ``matmul_plan`` in ``csrc/matmul.cu`` on the
    CPU, from the wrapper's own table: each CTA walks its cuboids' tiles
    row by row (wgmma's first tile column at m0 rounded down to 8, the
    columns before m0 not stored); a cuboid that shares no output writes
    C, the others their workspace rows (from m0 rounded down to 8, padded
    to 8); then each cell's parts, per element, in plan order in
    ``a.dtype``.  ``parts`` keeps each tile's f32 sums from one call to
    the next."""
    parts = {} if parts is None else parts
    tab = plan_table(plan)
    bm, bn = PLAN_TILES[variant]
    align = PLAN_COL_ALIGN[variant]
    dt = a.dtype
    out = torch.full((plan.n, plan.m), float("nan")).to(dt)
    ws = torch.full((tab.ws_elems,), float("nan")).to(dt)
    for ci in range(len(tab.cub)):   # every CTA's walk; order is moot here
        q = [int(x) for x in tab.cub[ci, :6]]
        nc, mc = q[1] - q[0], q[3] - q[2]
        shift = q[2] % align           # columns before m0: not stored
        tm = -(-(mc + shift) // bn)
        for t in range(-(-nc // bm) * tm):
            r0, c0 = (t // tm) * bm, (t % tm) * bn - shift
            if (ci, r0, c0) not in parts:
                parts[ci, r0, c0] = _tile_part(a, b, q, r0, c0, variant)
            skip = max(-c0, 0)
            part = parts[ci, r0, c0].to(dt)[:, skip:]
            c0 += skip
            rows, cols = min(bm, nc - r0), min(bn - skip, mc - c0)
            off = int(tab.ws_off[ci])
            if off < 0:
                out[q[0] + r0:q[0] + r0 + rows, q[2] + c0:q[2] + c0 + cols] = \
                    part[:rows, :cols]
            else:
                ld, pad = int(tab.cub[ci, 6]), q[2] % 8
                rows_ws = ws[off:off + nc * ld].view(nc, ld)
                rows_ws[r0:r0 + rows, pad + c0:pad + c0 + cols] = \
                    part[:rows, :cols]
    for r in range(len(tab.cell)):
        _sum_cell(out, ws, tab, r)
    return out


def _sum_cell(out, ws, tab, r):
    """``plan_sum_kernel`` on one cell: per element, the covering
    members' parts added in cell order (plan order) in the output dtype,
    the first taken as it is."""
    cr0, cr1, cc0, cc1, first, count = (int(x) for x in tab.cell[r, :6])
    acc = torch.zeros((cr1 - cr0, cc1 - cc0), dtype=out.dtype)
    seen = torch.zeros(acc.shape, dtype=torch.bool)
    for ci in tab.cell_mem[first:first + count]:
        n0, n1, m0, m1 = (int(x) for x in tab.cub[ci, :4])
        ld, off = int(tab.cub[ci, 6]), int(tab.ws_off[ci])
        part = ws[off:off + (n1 - n0) * ld].view(n1 - n0, ld)
        r0, r1, c0, c1 = max(cr0, n0), min(cr1, n1), max(cc0, m0), min(cc1, m1)
        if r0 >= r1 or c0 >= c1:
            continue
        m_al = m0 - m0 % 8
        dst = (slice(r0 - cr0, r1 - cr0), slice(c0 - cc0, c1 - cc0))
        x = part[r0 - n0:r1 - n0, c0 - m_al:c1 - m_al]
        acc[dst] = torch.where(seen[dst], acc[dst] + x, x)  # adds in dtype
        seen[dst] = True
    region = out[cr0:cr1, cc0:cc1]
    region[seen] = acc[seen]


def _fold_in_plan_order(parts, plan, dtype):
    """The plain version's reduction on given parts: zeros, then each
    part added in plan order in ``dtype``."""
    out = torch.zeros((plan.n, plan.m), dtype=dtype)
    cubs = [c for _, c in plan.tiles if c.volume()]
    for c, part in zip(cubs, parts):
        out[c.n0:c.n1, c.m0:c.m1] += part
    return out


@pytest.mark.parametrize("shape,p,planner", PLAN_CASES)
@pytest.mark.parametrize("variant,dtype", [("wgmma", torch.bfloat16),
                                           ("mma_sync", torch.bfloat16),
                                           ("wgmma_tf32x3", torch.float32)])
def test_matmul_plan_walk_matches_plain_and_jax(shape, p, planner, variant,
                                                dtype):
    """The plan walk: box-aligned k-steps from each cuboid's k0 rounded
    down to 8 (wgmma) or 4 (wgmma_tf32x3: three TF32 products, every 4
    steps' sum added into an f32 total) with A's columns outside [k0, k1)
    zeroed,
    the faces' own zero-filled k-walk (mma_sync), output tiles clipped to
    the cuboid, and the k-cut sums in plan order: within MM_TOL of the
    plain version and of ``repro.core.paco_matmul`` on JAX's CPU, and,
    given the walk's own parts, bitwise the plain version's sums."""
    n, k, m = shape
    ja, jb, ta, tb = _operands(4, n, k, m, dtype)
    plan = _plan(shape, p, planner)
    sums = {}
    got = emulate_matmul_plan(ta, tb, plan, variant, parts=sums)
    assert not got.float().isnan().any()
    want = matmul_plan_kernel(ta, tb, plan)   # the CPU: the plain version
    assert torch.equal(want, matmul_plan_ref(ta, tb, plan))
    assert _rel(got, want) <= MM_TOL[dtype]
    key = (shape, p, planner, dtype)
    if key not in _JAX_PLANS:   # the two bf16 variants share it
        thr = plan_throughputs(planner, p)
        _JAX_PLANS[key] = np.asarray(_jpaco_matmul(
            ja, jb, p, planner=planner,
            throughputs=None if thr is None else tuple(thr)), np.float32)
    jwant = _JAX_PLANS[key]
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(got.float().numpy(), jwant, rtol=0,
                               atol=tol * max(1.0, np.abs(jwant).max()))
    # the walk's parts, summed by the plain reduction, bit for bit
    tab = plan_table(plan)
    parts = []
    for i in np.argsort(tab.rank):
        q = [int(x) for x in tab.cub[i, :6]]
        nc, mc = q[1] - q[0], q[3] - q[2]
        bm, bn = PLAN_TILES[variant]
        shift = q[2] % PLAN_COL_ALIGN[variant]
        part = torch.empty((nc, mc + shift), dtype=dtype)
        for r0 in range(0, nc, bm):
            for c0 in range(0, mc + shift, bn):
                blk = part[r0:r0 + bm, c0:c0 + bn]
                blk.copy_(sums[i, r0, c0 - shift]
                          [:blk.shape[0], :blk.shape[1]].to(dtype))
        parts.append(part[:, shift:])
    assert torch.equal(got, _fold_in_plan_order(parts, plan, dtype))
    # each part against matmul_pallas where its blocks divide the face
    cubs = [c for _, c in plan.tiles if c.volume()]
    for c, part in zip(cubs, parts):
        blocks = [next((bl for bl in (64, 32, 16, 8) if x % bl == 0), None)
                  for x in (c.n, c.m, c.k)]
        if None in blocks:
            continue
        jpart = matmul_pallas(ja[c.n0:c.n1, c.k0:c.k1],
                              jb[c.k0:c.k1, c.m0:c.m1], bn=blocks[0],
                              bm=blocks[1], bk=blocks[2], interpret=True)
        np.testing.assert_allclose(part.float().numpy(),
                                   np.asarray(jpart, np.float32),
                                   atol=tol, rtol=tol)


def plan_throughputs(planner, p):
    return [1.0 + i % 3 for i in range(p)] if planner == "hetero" else None


@pytest.mark.parametrize("shape,p", [((8192, 8192, 8192), 132),
                                     ((8192, 8192, 8192), 131),
                                     ((65536, 512, 8192), 132),
                                     ((64, 64, 64), 13), ((61, 67, 97), 12)])
def test_matmul_plan_table_covers_each_shared_output_once(shape, p):
    """The tables of the main path's plans: one CTA per processor; each
    cell inside one aligned band of PLAN_CELL[1] columns and no larger
    than PLAN_CELL; the cells of one group disjoint and covering each of
    its cuboids' outputs exactly; a cell's members exactly the group's
    cuboids that meet it, in plan order; workspace rows 16-byte aligned."""
    n, k, m = shape
    plan = TCM.plan(n, m, k, p)
    tab = plan_table(plan)
    assert tab.n_ctas == sum(1 for _, c in plan.tiles if c.volume()) == \
        len(tab.cub)
    cells = tab.cell.astype(np.int64)
    cr, cc = PLAN_CELL
    assert np.all(cells[:, 0] // cr == (cells[:, 1] - 1) // cr)
    assert np.all(cells[:, 2] // cc == (cells[:, 3] - 1) // cc)
    shared = tab.ws_off >= 0
    assert np.all(tab.ws_off[shared] % 8 == 0)
    assert np.all(tab.cub[:, 6] % 8 == 0)
    cells_of = {}
    for r, (f, c) in enumerate(cells[:, 4:6]):
        mem = tab.cell_mem[f:f + c]
        assert np.all(np.diff(tab.rank[mem]) > 0)      # plan order
        for i in mem:
            cells_of.setdefault(int(i), []).append(r)
    for i in np.flatnonzero(shared):
        n0, n1, m0, m1 = (int(x) for x in tab.cub[i, :4])
        mine = np.asarray(cells_of[int(i)])
        inter = ((np.minimum(cells[mine, 1], n1)
                  - np.maximum(cells[mine, 0], n0)).clip(0)
                 * (np.minimum(cells[mine, 3], m1)
                    - np.maximum(cells[mine, 2], m0)).clip(0))
        assert inter.sum() == (n1 - n0) * (m1 - m0) and np.all(inter > 0)
    assert sorted(cells_of) == list(np.flatnonzero(shared))
    if shape == (65536, 512, 8192):    # no k-cut: every part goes to C
        assert tab.ws_elems == 0 and len(tab.cell) == 0


def test_matmul_plan_tile_layout_reads_what_tma_wrote():
    """The wgmma walk's shared-memory stage: A as one 128 x 64 box, B as
    four 64 x 64 boxes 8 KB apart, both in TMA's 128-byte swizzle.  Each
    warpgroup's K-major A descriptor (64 rows from row0, k-step ks) and the
    MN-major B descriptor (16 k-rows per step, 256 columns, lbo 64 x 128)
    read the intended operand, and the zeroing of A's columns addresses
    element (r, e) where TMA put it."""
    mem_a = _tma_tile(128, 64)
    for row0 in (0, 64):
        for ks in range(4):
            start = row0 * 128 + ks * 32
            assert _read_k_major(mem_a, start, 1024, 64) == [
                [(row0 + i, 16 * ks + kk) for kk in range(16)]
                for i in range(64)]
    mem_b = _tma_tile(64, 256)
    for ks in range(4):
        assert _read_mn_major(mem_b, ks * 16 * 128, 64 * 128, 1024, 256) == [
            [(16 * ks + kk, nn) for nn in range(256)] for kk in range(16)]
    for r in range(128):
        for e in range(64):   # zero_a_tail's address of element e of row r
            addr = r * 128 + (((e >> 3) ^ (r & 7)) << 4) + 2 * (e & 7)
            assert mem_a[addr] == (r, e)


def _sw128(addr):
    """TMA's 128-byte swizzle of a byte offset from a 1024-byte aligned
    base: the 16-byte unit within each 128-byte row XOR the row's index
    within its 8-row atom (as tests/test_torch_flash_attention.py)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma_tile(rows, cols):
    """A rows x cols bf16 tile as 64-column boxes of rows x 128 bytes
    each, swizzled: {byte offset: (row, column)}."""
    return {_sw128(c * rows * 128 + r * 128 + 2 * j): (r, 64 * c + j)
            for c in range(cols // 64) for r in range(rows)
            for j in range(64)}


def _read_k_major(mem, start, sbo, rows):
    return [[mem[_sw128(start + (i // 8) * sbo + (i % 8) * 128 + 2 * kk)]
             for kk in range(16)] for i in range(rows)]


def _read_mn_major(mem, start, lbo, sbo, n):
    return [[mem[_sw128(start + (nn // 64) * lbo + 2 * (nn % 64)
                        + (kk // 8) * sbo + (kk % 8) * 128)]
             for nn in range(n)] for kk in range(16)]


def test_tf32_stage_layout_reads_what_tma_wrote():
    """The wgmma_tf32x3 stage: A as a 128 x 32 f32 box and B^T's hi and lo
    as 128 x 32 boxes, TMA's 128-byte swizzle.  The consumers' address of
    A's element (r, col) (``plan_tf32x3_kernel``: float r * 32 + ((col / 4)
    ^ (r % 8)) * 4 + col % 4) reads it where TMA put it, a warp's 32 reads
    of a register fragment (rows g and g + 8, columns t4 and t4 + 4 of a
    k8 slice) fall in 32 distinct banks, and the K-major descriptor of k8
    slice s (``desc_k``: 32 s bytes in, sbo 1024) reads B^T's rows at
    columns 8 s to 8 s + 7."""
    mem = {_sw128(r * 128 + 4 * j): (r, j) for r in range(128)
           for j in range(32)}
    for r in range(128):
        for col in range(32):
            at = 4 * (r * 32 + (((col >> 2) ^ (r & 7)) << 2) + (col & 3))
            assert mem[at] == (r, col)
    for wg in range(2):
        for warp in range(4):
            for s in range(4):
                for e in range(4):
                    banks = set()
                    for lane in range(32):
                        g, t4 = lane >> 2, lane & 3
                        r = 64 * wg + 16 * warp + g + 8 * (e & 1)
                        col = 8 * s + t4 + 4 * (e >> 1)
                        banks.add(
                            (r * 32 + (((col >> 2) ^ (r & 7)) << 2)
                             + (col & 3)) % 32)
                    assert len(banks) == 32
    for s in range(4):
        got = [[mem[_sw128(s * 32 + (i // 8) * 1024 + (i % 8) * 128
                           + 4 * kk)] for kk in range(8)]
               for i in range(128)]
        assert got == [[(i, 8 * s + kk) for kk in range(8)]
                       for i in range(128)]


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits, ties away from zero, in float64, then
    to float32 (past float32's range: infinity)."""
    mant, exp = np.frexp(x.astype(np.float64))
    r = np.sign(mant) * np.floor(np.abs(mant) * 2.0 ** 11 + 0.5)
    with np.errstate(over="ignore"):
        return np.ldexp(r / 2.0 ** 11, exp).astype(np.float32)


def test_tf32_rounding_ties_away_and_splits_exactly():
    """``tf32_round``: exact halfway cases go away from zero (1 + 2^-11 ->
    1 + 2^-10, 1 + 3 2^-11 -> 1 + 2^-9, and their negatives), zero and
    signed zero stay, a value at or past the halfway point above TF32's
    largest becomes infinity and one just below it TF32's largest, inf and
    nan pass; on a million normal values it equals the float64 reference,
    and hi + lo of ``tf32_split`` is x to within 2^-21 of |x|."""
    one = 1.0
    cases = {one + 2 ** -11: one + 2 ** -10, one + 3 * 2 ** -11: one + 2 ** -9,
             one + 2 ** -11 - 2 ** -23: one, -(one + 2 ** -11): -(one + 2 ** -10),
             -(one + 3 * 2 ** -11): -(one + 2 ** -9), 0.0: 0.0,
             3 * 2.0 ** -12: 3 * 2.0 ** -12,
             (2 - 2 ** -11) * 2.0 ** 127: float("inf"),
             -(2 - 2 ** -11) * 2.0 ** 127: float("-inf"),
             (2 - 2 ** -11 - 2 ** -23) * 2.0 ** 127: (2 - 2 ** -10) * 2.0 ** 127,
             float(np.finfo(np.float32).max): float("inf"),
             float("inf"): float("inf"), float("-inf"): float("-inf")}
    x = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    assert torch.equal(tf32_round(x).view(torch.int32) & 0x1FFF,
                       torch.zeros_like(x, dtype=torch.int32))
    assert torch.equal(torch.from_numpy(_tf32_reference(x.numpy())), want)
    neg0 = tf32_round(torch.tensor([-0.0]))
    assert neg0.item() == 0.0 and torch.signbit(neg0).item()
    assert tf32_round(torch.tensor([float("nan")])).isnan().all()
    rng = np.random.default_rng(7)
    v = (rng.standard_normal(1 << 20)
         * 2.0 ** rng.integers(-60, 60, 1 << 20)).astype(np.float32)
    hi, lo = tf32_split(torch.from_numpy(v))
    assert np.array_equal(hi.numpy(), _tf32_reference(v))
    err = np.abs(v.astype(np.float64) - hi.double().numpy()
                 - lo.double().numpy())
    assert np.all(err <= 2.0 ** -21 * np.abs(v))


def test_one_tf32_pass_fails_mm_tol_and_three_pass_the_walk_meets_it():
    """At (128, 8192, 128) on normal operands, relative to max(1, max
    |plain|) against the true f32 product: one TF32 product (A_hi B_hi
    alone) errs past MM_TOL[float32]; the walk's three, every 128 of k
    summed from zero and added into an f32 total, stay within it by a
    factor of 10 (the card: chip_smoke.py's k = 8192 case)."""
    n, k, m = 128, 8192, 128
    _, _, ta, tb = _operands(8, n, k, m, torch.float32)
    want = matmul_ref(ta, tb)
    steps = [(ta[:, kb:kb + 32], tb[kb:kb + 32]) for kb in range(0, k, 32)]
    errs = {passes: _rel(_tf32x3_walk(steps, passes), want)
            for passes in (1, 3)}
    assert errs[1] > MM_TOL[torch.float32] > 10 * errs[3], errs


def test_matmul_bench_needs_a_card_and_its_ablations_apply(monkeypatch,
                                                           capsys):
    """``launch.matmul_bench`` exits 2 without a card, and each ablated
    copy's source edits still find their text in ``csrc/matmul.cu``."""
    from repro_torch.kernels import build
    from repro_torch.launch import matmul_bench
    src = (build.CSRC / "matmul.cu").read_text()
    for edits in matmul_bench.ABLATIONS.values():
        text = src
        for old, new in edits:
            assert old in text
            text = text.replace(old, new)
        assert text != src
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert matmul_bench.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_paco_matmul_runs_the_plan_once_and_keeps_its_tables(monkeypatch):
    """paco_matmul hands the whole (cached) plan to one matmul_plan call,
    and on the CPU returns the plain version bit for bit."""
    calls = []
    real = TCM.mm_ops.matmul_plan

    def spy(a, b, plan):
        calls.append(plan)
        return real(a, b, plan)

    monkeypatch.setattr(TCM.mm_ops, "matmul_plan", spy)
    _, _, ta, tb = _operands(5, 61, 97, 67, torch.bfloat16)
    got = TC.paco_matmul(ta, tb, 12)
    again = TC.paco_matmul(ta, tb, 12)
    assert len(calls) == 2 and calls[0] is calls[1]
    assert torch.equal(got, again)
    assert torch.equal(got, matmul_plan_ref(ta, tb, calls[0]))


# ---------------------------------------------------------------------------
# LCS
# ---------------------------------------------------------------------------

def _ring_done(blk0: int, slots: int) -> list[int]:
    """Phases each hand-off slot has completed after ``blk0`` blocks of a
    CTA's earlier tiles."""
    return [len(range(q, blk0, slots)) for q in range(slots)]


def emulate_skewed_sweep(s_tiles, t_tiles, top, left, corner, run: int = 8,
                         block: int = 16, slots: int = 4, blk0: int = 0,
                         seed: int = 0):
    """The per-CTA sweep of ``csrc/lcs_tile.cu`` for T tiles at once.

    Lane k of warp w owns columns c0 = (32 w + k) * run .. c0 + run - 1
    (zero past the tile, as the kernel loads them) and does row r at its
    warp's step r + k: X[r, c0 - 1] from lane k - 1 (``__shfl_up_sync``),
    or at lane 0 from ``left`` (warp 0) or the hand-off ring of the warp
    before; one three-way max over a wrapping add a cell.  Warps advance
    in a seeded random order, each step only once its waits hold: a
    consumer's "full" phase at the first row of each block, a producer's
    "empty" phase before it overwrites a slot; ``blk0`` blocks of earlier
    tiles set the phases' start, as in a CTA's later tiles."""
    rng = np.random.default_rng(seed)
    n_t, m = s_tiles.shape
    n = t_tiles.shape[1]
    nw = -(-n // (32 * run))
    lanes = 32 * nw
    width = lanes * run

    def pad(x):
        return torch.cat([x, torch.zeros(n_t, width - n, dtype=x.dtype)], 1)

    tv = pad(t_tiles).view(n_t, nw, 32, run)
    prev = pad(top).view(n_t, nw, 32, run).clone()
    c0 = torch.arange(lanes) * run
    top_x = torch.cat([top, torch.zeros(n_t, 1, dtype=top.dtype)], 1)
    diag = torch.where(c0 == 0, corner[:, None],
                       top_x[:, (c0 - 1).clamp(0, n)])
    diag = torch.where(c0 <= n, diag, 0).view(n_t, nw, 32).clone()
    last = torch.zeros(n_t, nw, 32, dtype=torch.int32)
    right = torch.zeros(n_t, m, dtype=torch.int32)
    owner, at = (n - 1) // run, (n - 1) % run
    hand = torch.zeros(max(nw - 1, 1), slots, block, n_t, dtype=torch.int32)
    full = [_ring_done(blk0, slots) for _ in range(nw)]
    empty = [_ring_done(blk0, slots) for _ in range(nw)]
    step = [0] * nw
    lane = torch.arange(32)

    def can_step(w):
        st = step[w]
        g = blk0 + st // block
        if w > 0 and st < m and st % block == 0 \
                and full[w - 1][g % slots] < g // slots + 1:
            return False
        r31 = st - 31
        g = blk0 + r31 // block
        return not (w < nw - 1 and 0 <= r31 < m and r31 % block == 0
                    and g >= slots and empty[w][g % slots] < g // slots)

    while any(step[w] < m + 31 for w in range(nw)):
        ready = [w for w in range(nw) if step[w] < m + 31 and can_step(w)]
        assert ready, "the strips' pipeline is stuck"
        w = int(rng.choice(ready))
        st = step[w]
        x = torch.roll(last[:, w], 1, dims=1)
        if st < m:
            if w == 0:
                x[:, 0] = left[:, st]
            else:
                g = blk0 + st // block
                x[:, 0] = hand[w - 1, g % slots, st % block]
                if st % block == block - 1 or st == m - 1:
                    empty[w - 1][g % slots] += 1
        r = st - lane
        active = (r >= 0) & (r < m)
        si = s_tiles[:, r.clamp(0, m - 1)]
        cur, dg = x, diag[:, w]
        for q in range(run):
            p = prev[:, w, :, q].clone()
            cell = torch.maximum(torch.maximum(cur, p),
                                 dg + (tv[:, w, :, q] == si).int())
            cur = torch.where(active, cell, cur)
            prev[:, w, :, q] = torch.where(active, cell, p)
            dg = p
        diag[:, w] = torch.where(active, x, diag[:, w])
        last[:, w] = torch.where(active, cur, last[:, w])
        k = owner - 32 * w
        if 0 <= k < 32 and active[k]:
            right[:, r[k]] = prev[:, w, k, at]
        if w < nw - 1 and active[31]:
            r31 = int(r[31])
            g = blk0 + r31 // block
            hand[w, g % slots, r31 % block] = cur[:, 31]
            if r31 % block == block - 1 or r31 == m - 1:
                full[w][g % slots] += 1
        step[w] += 1
    return prev.reshape(n_t, width)[:, :n], right


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
        top[:, 3::11], left[:, 2::9] = -hi - 1, -hi - 1
    return [np.asarray(x, np.int32) for x in (s, t, top, left, corner)]


@pytest.mark.parametrize("m,n,run", [(8, 8, 8), (16, 16, 4), (32, 32, 8),
                                     (5, 7, 4), (1, 1, 8), (16, 300, 4),
                                     (9, 520, 8), (40, 129, 4)])
@pytest.mark.parametrize("kind", ["monotone", "any"])
def test_lcs_walk_matches_pallas_and_plain(m, n, run, kind):
    """One tile against lcs_tile_pallas in interpret mode: the tiles of
    tests/test_kernels.py:114, ragged ones, and tiles wide enough for
    several strips, on DP borders and on arbitrary int32 ones (INT32_MIN
    and INT32_MAX among them)."""
    rng = np.random.default_rng(m * 1000 + n)
    s, t, top, left, corner = _borders(rng, 1, m, n, kind)
    want_b, want_r = lcs_tile_pallas(
        jnp.asarray(s[0]), jnp.asarray(t[0]), jnp.asarray(top[0]),
        jnp.asarray(left[0]), jnp.asarray(corner), interpret=True)
    ts = [torch.from_numpy(x) for x in (s, t, top, left, corner)]
    for got_b, got_r in (emulate_skewed_sweep(*ts, run=run, seed=m + n),
                         lcs_tiles_ref(*ts),
                         [x[None] for x in lcs_tile_ref(
                             *(x[0] for x in ts[:4]), ts[4])],
                         [x[None] for x in lcs_tile_kernel(
                             *(x[0] for x in ts[:4]), ts[4])]):
        np.testing.assert_array_equal(got_b[0].numpy(), np.asarray(want_b))
        np.testing.assert_array_equal(got_r[0].numpy(), np.asarray(want_r))


@pytest.mark.parametrize("n_t,m,n,run,blk0", [(5, 16, 16, 8, 0),
                                              (3, 7, 40, 4, 3),
                                              (4, 33, 260, 4, 6),
                                              (2, 50, 1030, 8, 9)])
@pytest.mark.parametrize("kind", ["monotone", "any"])
def test_lcs_batched_walk_matches_jax_per_tile(n_t, m, n, run, blk0, kind):
    """T > 1 tiles at once: the batched plain version and the sweep (its
    strips pipelined through the hand-off ring from a later tile's ring
    phases) against JAX's plain version tile by tile."""
    rng = np.random.default_rng(n_t + m + n)
    s, t, top, left, corner = _borders(rng, n_t, m, n, kind)
    ts = [torch.from_numpy(x) for x in (s, t, top, left, corner)]
    walk_b, walk_r = emulate_skewed_sweep(*ts, run=run, blk0=blk0, seed=m)
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
    """The port's one-launch wavefront (one border buffer of each kind)
    against lcs_pallas's per-tile loop and the reference."""
    rng = np.random.default_rng(n + p)
    s, t = rng.integers(0, 4, n), rng.integers(0, 4, n)
    js, jt = jnp.asarray(s, jnp.int32), jnp.asarray(t, jnp.int32)
    want = int(jlcs_reference(js, jt))
    if n % 8 == 0 and tile is None:
        assert int(lcs_pallas(js, jt, p, interpret=True)) == want
    ts, tt = (torch.tensor(x, dtype=torch.int32) for x in (s, t))
    launches = KL.lcs_table_kernel.launches
    assert int(lcs_wavefront(ts, tt, p, tile=tile)) == want
    assert KL.lcs_table_kernel.launches == launches  # CPU: plain version


def test_wavefront_diagonals_through_the_walk(monkeypatch):
    """Each anti-diagonal's tiles through the sweep emulation, in the
    kernel's border layout: the table's LCS comes out exact, the plain
    version batching one call per diagonal (ti + tj - 1)."""
    calls = []

    def walk(*tiles):
        calls.append(tiles[0].shape[0])
        return emulate_skewed_sweep(*tiles, run=4)

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
    """A tile larger than one CTA takes is cut into tiles of the same
    launch, ragged at the far edges (the right column of one is the next
    one's left border, the bottom row the next one's top, X[-1, j0 - 1]
    the first tile row's corners): exact on any borders."""
    monkeypatch.setattr(KL, "_tile_shape", lambda m, n, cuda: (4, 5))
    rng = np.random.default_rng(3)
    for kind in ("monotone", "any"):
        s, t, top, left, corner = (torch.from_numpy(x[0] if x.ndim > 1
                                                    else x)
                                   for x in _borders(rng, 1, 9, 23, kind))
        got = lcs_tile_kernel(s, t, top, left, corner)
        want = lcs_tile_ref(s, t, top, left, corner)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def _claim_order(ti: int, tj: int):
    """The tiles in the kernel's claim order: its per-CTA cursor over the
    anti-diagonals, for claims 0, 1, 2, ..."""
    def count(d):
        return min(d + 1, ti, tj, ti + tj - 1 - d)
    d = base = 0
    for k in range(ti * tj):
        while k >= base + count(d):
            base += count(d)
            d += 1
        i = max(0, d - tj + 1) + k - base
        yield i, d - i


@pytest.mark.parametrize("m,n,tile_m,tile_n,ctas,kind", [
    (64, 64, 8, 8, 3, "zero"), (64, 48, 8, 16, 8, "zero"),
    (50, 37, 8, 10, 4, "any"), (30, 70, 7, 9, 64, "any")])
def test_claim_schedule_in_random_order_is_exact(m, n, tile_m, tile_n, ctas,
                                                 kind):
    """The launch's schedule, one CTA per slot of ``ctas``: each claims the
    next tile in anti-diagonal order, starts it (reads its borders) once
    its top and left flags are set, and finishes it (writes its borders,
    then its flags) later; a seeded random order picks among every start
    and finish that may happen.  Some step can always happen (no
    deadlock), and the table comes out as ``lcs_reference`` (zero borders)
    or as one tile through the plain version (any borders)."""
    rng = np.random.default_rng(m + n + ctas)
    s, t, top, left, corner = (torch.from_numpy(x[0] if x.ndim > 1 else x)
                               for x in _borders(rng, 1, m, n, "any"))
    if kind == "zero":
        top, left, corner = (torch.zeros_like(x) for x in (top, left,
                                                           corner))
    ti, tj = -(-m // tile_m), -(-n // tile_n)
    state = KL._state(top, left, corner, tile_n, ti, tj)
    rows, cols = state[:n], state[n:n + m]
    corners = state[n + m:n + m + tj]
    colprog, rowprog = [0] * tj, [0] * ti
    claims = _claim_order(ti, tj)
    held = [next(claims, None) for _ in range(ctas)]
    started = [None] * ctas
    while any(h is not None for h in held):
        moves = []
        for c, h in enumerate(held):
            if h is None:
                continue
            i, j = h
            if started[c] is not None:
                moves.append(("finish", c))
            elif colprog[j] >= i and rowprog[i] >= j:
                moves.append(("start", c))
        assert moves, "no CTA can move: the schedule deadlocks"
        what, c = moves[int(rng.integers(len(moves)))]
        i, j = held[c]
        r = slice(i * tile_m, min(m, (i + 1) * tile_m))
        cc = slice(j * tile_n, min(n, (j + 1) * tile_n))
        if what == "start":
            lft = cols[r].clone()
            started[c] = (lcs_tile_ref(s[r], t[cc], rows[cc].clone(), lft,
                                       corners[j:j + 1].clone()), lft[-1])
        else:
            (bottom, right), corner_out = started[c]
            rows[cc], cols[r], corners[j] = bottom, right, corner_out
            colprog[j], rowprog[i] = i + 1, j + 1
            started[c] = None
            held[c] = next(claims, None)
    want_b, want_r = lcs_tile_ref(s, t, top, left, corner)
    assert torch.equal(rows, want_b) and torch.equal(cols, want_r)
    if kind == "zero":
        assert int(rows[-1]) == int(jlcs_reference(jnp.asarray(s.numpy()),
                                                   jnp.asarray(t.numpy())))


def test_lcs_wrappers_reject_what_they_do_not_take():
    s = torch.zeros(8, dtype=torch.int32)
    one = s[:1]
    with pytest.raises(ValueError, match="empty"):
        KL.lcs_table_kernel(s, s, s, s, one, 0, 8)
    with pytest.raises(TypeError, match="int32"):
        KL.lcs_table_kernel(s.long(), s, s, s, one, 8, 8)
    with pytest.raises(ValueError, match="shape"):
        KL.lcs_table_kernel(s, s, s[:4], s, one, 8, 8)
    with pytest.raises(ValueError, match="M, N >= 1"):
        lcs_tile_kernel(s[:0], s, s, s[:0], s[:1])
    with pytest.raises(ValueError, match="does not divide"):
        lcs_wavefront(s, s, 2, tile=3)


def test_lcs_wrappers_count_launches_by_walk_only_on_the_card():
    """On the CPU the table takes the plain version: no launch, no
    variant counted."""
    before = (KL.lcs_table_kernel.launches,
              dict(KL.lcs_table_kernel.variants))
    s = torch.arange(16, dtype=torch.int32) % 4
    for tile in (None, 4, 8):
        lcs_wavefront(s, s.flip(0), 4, tile=tile)
    assert (KL.lcs_table_kernel.launches,
            dict(KL.lcs_table_kernel.variants)) == before


def test_lcs_bench_ablations_still_apply():
    """``launch.lcs_bench --ablate`` builds copies of ``csrc/lcs_tile.cu``
    with the other run of columns a lane, without its cells or without its
    neighbour waits: each edit still finds its text, and changes it."""
    from repro_torch.kernels import build
    from repro_torch.launch import lcs_bench
    src = (build.CSRC / "lcs_tile.cu").read_text()
    copies = lcs_bench.ablated_sources(build.CSRC)
    assert set(copies) == set(lcs_bench.ABLATIONS)
    assert all(text != src for text in copies.values())
