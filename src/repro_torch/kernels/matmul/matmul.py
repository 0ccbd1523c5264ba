"""Hand-written Hopper kernels for the blocked matmul, and their wrappers.

``matmul_kernel`` and ``matmul_plan_kernel`` replace the TPU kernel
``repro/kernels/matmul/matmul.py: matmul_pallas`` with ``csrc/matmul.cu``:
C = A @ B, the sum over k accumulated in float32 and written once in
``a.dtype``.  Unlike the TPU kernel, whose blocks must divide the shape,
they take any n, m and k: their loads are predicated and zero-filled at
the ragged edges.

``matmul_kernel`` is one product (a Strassen leaf, ``ops.matmul``).  A and
B may be views with a row stride, read in place.  It counts its launches
by variant too (``variants``): ``"mma_sync"`` (bf16) and
``"wgmma_tf32x3"`` (float32).

``matmul_plan_kernel`` is a whole PACO matmul plan in one launch, one CTA
per processor walking its cuboids (``paco_matmul`` on the card).  Each
cuboid's part is rounded to ``a.dtype``, and parts that share outputs
(k-cuts) are added into C in the output dtype in plan order, as
``ref.matmul_plan_ref`` does: the kernel writes such parts to a
workspace, and a second launch sums each 128 x 256 cell's parts in plan
order, so the result is the same bit for bit on every call.
``plan_table`` lays the plan out for the kernels (cuboids, workspace,
cells); the device copy is built once per plan and kept.  Besides
``launches``, the wrapper counts the cuboids it walked (``cuboids``) and
its launches by variant (``variants``): ``"wgmma"`` (bf16 through TMA and
wgmma, when both row strides are multiples of 8 and both bases 16-byte
aligned), ``"mma_sync"`` (other bf16) and ``"wgmma_tf32x3"`` (float32).

Float32 runs on the tensor cores as three TF32 products: each operand
split into a TF32 hi part and the TF32-rounded rest (lo), and A_lo B_hi +
A_hi B_lo + A_hi B_hi summed in float32.  That holds the product to
float32 accuracy: at k = 8192 on normal operands 1.6e-6 to 2.7e-6 of the
largest output on an H100 (6e-7 in tests/test_torch_paco_kernels.py's
CPU emulation), against MM_TOL's 1e-5, where one TF32 product errs by
2.5e-4.  The float32 entries need a workspace for B^T's parts (and for A
where TMA cannot read it in place), which the wrappers allocate; the
plain versions stay true float32.

What bounds them on the card: operations, 2 n m k flops at 989 TFLOP/s in
bf16; in float32 3 x 2 n m k TF32 flops at 495 TFLOP/s
(``kernels.work.TF32_PASSES``).  ``csrc/matmul.cu``'s header says
what the designs do about it.

The wrappers check device, dtype, shape and strides and raise on anything
else, allocate C (and the plan's workspace) with ``torch.empty``, launch
on the current stream, raise if the launch reports a CUDA error, and
count.  A CPU tensor takes the plain version (``ref.matmul_ref``,
``ref.matmul_plan_ref``) instead.  A fake tensor (``FakeTensorMode``)
allocates C and the plan's workspace as fake tensors and records the
product's work (``kernels.work.matmul_work``) in the open counters, with
no launch; a real launch records the same when a counter is open.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels.build import c_function
from repro_torch.kernels import work as _work

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
INT32_MAX = 2 ** 31 - 1
# The plan kernel's variants, numbered as in csrc/matmul.cu, the output
# tile each walks (wgmma's first tile column starts at a cuboid's m0
# rounded down to a multiple of PLAN_COL_ALIGN: its TMA boxes start a row
# on a 16-byte boundary), and the cells the sum pass takes one per CTA.
PLAN_VARIANTS = ("wgmma_tf32x3", "mma_sync", "wgmma")
PLAN_TILES = {"wgmma_tf32x3": (128, 128), "mma_sync": (128, 128),
              "wgmma": (128, 256)}
PLAN_COL_ALIGN = {"wgmma_tf32x3": 1, "mma_sync": 1, "wgmma": 8}
PLAN_CELL = (128, 256)


def _row_stride(name: str, t: torch.Tensor) -> int:
    """The row stride of a 2-D operand whose elements are contiguous
    along each row."""
    rows, cols = t.shape
    if cols > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} must have unit column stride, got strides "
                         f"{t.stride()}")
    stride = t.stride(0) if rows > 1 else max(cols, 1)
    if stride < cols:
        raise ValueError(f"{name} rows overlap: strides {t.stride()} for "
                         f"shape {tuple(t.shape)}")
    return stride


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int]:
    """Checks both wrappers make; returns (n, m, k)."""
    if a.dtype not in _DTYPES:
        raise TypeError(f"a has dtype {a.dtype}; the kernel takes "
                        f"{sorted(map(str, _DTYPES))}")
    if b.dtype != a.dtype:
        raise TypeError(f"b has dtype {b.dtype}, expected {a.dtype}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, expected {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} do "
                         f"not form a matrix product")
    n, k = a.shape
    m = b.shape[1]
    if max(n, m, k) > INT32_MAX:
        raise ValueError(f"({n}, {m}, {k}) exceeds the kernel's 32-bit "
                         f"extents")
    return n, m, k


def matmul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B (``csrc/matmul.cu``: ``matmul`` in bf16,
    ``matmul_tf32x3`` in float32).

    a (n, k) and b (k, m): float32 or bfloat16, the same dtype, on one
    CUDA device, each with unit column stride and any row stride.  Returns
    a contiguous (n, m) tensor in ``a.dtype``.  On the CPU it returns the
    plain version.
    """
    if not a.is_cuda and not _work.is_fake(a):
        from repro_torch.kernels.matmul.ref import matmul_ref
        return matmul_ref(a, b)
    n, m, k = _check_operands(a, b)
    lda, ldb = _row_stride("a", a), _row_stride("b", b)
    out = torch.empty((n, m), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    if _work.tracing(a) and _work.record_call("matmul", a, lambda fake: (
            _work.matmul_work(n, m, k, a.element_size()))):
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if a.dtype == torch.float32:
            split = _split_workspace(a, n, m, k, lda)
            err = c_function("matmul", "matmul_tf32x3", (
                _P, _P, _P, _P, _L, _I, _I, _I, _L, _L, _P))(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), split.data_ptr(),
                split.numel(), n, m, k, lda, ldb, stream)
        else:
            err = c_function("matmul", "matmul", (
                _I, _P, _P, _P, _I, _I, _I, _L, _L, _P))(
                _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), out.data_ptr(),
                n, m, k, lda, ldb, stream)
    if err:
        raise RuntimeError(f"matmul launch failed: CUDA error {err}")
    matmul_kernel.launches += 1
    matmul_kernel.variants["wgmma_tf32x3" if a.dtype == torch.float32
                           else "mma_sync"] += 1
    return out


matmul_kernel.launches = 0
matmul_kernel.variants = collections.Counter()


def _split_workspace(a: torch.Tensor, n: int, m: int, k: int,
                     lda: int) -> torch.Tensor:
    """The float32 entries' workspace: B^T's TF32 hi and lo parts, and A
    padded where TMA cannot read it in place (``csrc/matmul.cu``:
    ``matmul_tf32x3_ws_floats`` sizes it)."""
    floats = c_function("matmul", "matmul_tf32x3_ws_floats",
                        (_I, _I, _I, _L, _P), _L)(n, m, k, lda, a.data_ptr())
    return torch.empty(max(floats, 4), dtype=torch.float32, device=a.device)


# ---------------------------------------------------------------------------
# a whole plan in one call
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanTable:
    """A plan laid out for ``matmul_plan``'s walk (``csrc/matmul.cu``:
    ``Plan``).

    Cuboids (the non-empty ones) are numbered in walk order: processor by
    processor, in the order processors first appear in the plan, and each
    processor's in plan order; ``rank`` is each one's place in plan order.
    CTA i walks cuboids ``proc_off[i]`` to ``proc_off[i + 1]``.  A cuboid
    whose output no other cuboid covers writes C; the others write their
    part to the workspace at ``ws_off``, in rows that start at m0 rounded
    down to a multiple of 8 and are ``cub[:, 6]`` long (a multiple of 8).
    The sum pass then takes one cell per CTA: a ``PLAN_CELL`` block of the
    output (inside one aligned band of ``PLAN_CELL[1]`` columns) clipped
    to the bounding box of the cuboids of one overlapping group that meet
    it; ``cell`` rows are (r0, r1, c0, c1, first member, members, 0, 0),
    the members (``cell_mem``) in plan order."""

    proc_off: np.ndarray   # int32 (n_ctas + 1,)
    cub: np.ndarray        # int32 (n_cub, 8): n0, n1, m0, m1, k0, k1, ld, 0
    rank: np.ndarray       # int32 (n_cub,)
    ws_off: np.ndarray     # int64 (n_cub,), -1: written to C
    cell: np.ndarray       # int32 (n_cells, 8)
    cell_mem: np.ndarray   # int32
    ws_elems: int

    @property
    def n_ctas(self) -> int:
        return len(self.proc_off) - 1


def _overlap_groups(rects: np.ndarray) -> np.ndarray:
    """Connected components of the (n0, n1, m0, m1) rectangles under
    overlap: a label per rectangle."""
    n0, n1, m0, m1 = (rects[:, i] for i in range(4))
    adj = ((n0[:, None] < n1[None, :]) & (n0[None, :] < n1[:, None])
           & (m0[:, None] < m1[None, :]) & (m0[None, :] < m1[:, None]))
    label = np.full(len(rects), -1)
    for seed in range(len(rects)):
        if label[seed] >= 0:
            continue
        label[seed] = seed
        frontier = [seed]
        while frontier:
            nxt = np.flatnonzero(adj[frontier].any(0) & (label < 0))
            label[nxt] = seed
            frontier = list(nxt)
    return label


def plan_table(plan, cell: tuple[int, int] = PLAN_CELL) -> PlanTable:
    """Lay ``plan`` (a ``core.cuboid.MMPlan``) out for the walk and the
    sum pass, cells of ``cell`` = (rows, cols)."""
    cr, cc = cell
    planned = [(proc, c) for proc, c in plan.tiles if c.volume()]
    procs = {p: i for i, p in enumerate(dict.fromkeys(
        proc for proc, _ in planned))}
    order = sorted(range(len(planned)),
                   key=lambda i: (procs[planned[i][0]], i))
    cubs = [planned[i][1] for i in order]
    rank = np.asarray(order, dtype=np.int32)
    per_proc = collections.Counter(planned[i][0] for i in order)
    proc_off = np.concatenate([[0], np.cumsum([per_proc[p] for p in procs])])

    rects = np.asarray([(c.n0, c.n1, c.m0, c.m1) for c in cubs],
                       dtype=np.int64).reshape(-1, 4)
    label = _overlap_groups(rects)
    shares = np.bincount(label, minlength=len(cubs))[label] > 1
    ld = -(-(rects[:, 3] - (rects[:, 2] - rects[:, 2] % 8)) // 8) * 8
    sizes = np.where(shares, (rects[:, 1] - rects[:, 0]) * ld, 0)
    ws_off = np.where(shares, np.cumsum(sizes) - sizes, -1).astype(np.int64)

    cell_rows, cell_mem = [], []
    for g in np.unique(label[shares]):
        mem = np.flatnonzero(label == g)
        mem = mem[np.argsort(rank[mem])]          # plan order
        box = rects[mem]
        for gi in range(int(box[:, 0].min()) // cr,
                        (int(box[:, 1].max()) - 1) // cr + 1):
            for gj in range(int(box[:, 2].min()) // cc,
                            (int(box[:, 3].max()) - 1) // cc + 1):
                r0, r1, c0, c1 = gi * cr, (gi + 1) * cr, gj * cc, (gj + 1) * cc
                meet = mem[(box[:, 0] < r1) & (box[:, 1] > r0)
                           & (box[:, 2] < c1) & (box[:, 3] > c0)]
                if len(meet) == 0:
                    continue
                mb = rects[meet]
                cell_rows.append((max(r0, int(mb[:, 0].min())),
                                  min(r1, int(mb[:, 1].max())),
                                  max(c0, int(mb[:, 2].min())),
                                  min(c1, int(mb[:, 3].max())),
                                  len(cell_mem), len(meet), 0, 0))
                cell_mem.extend(int(i) for i in meet)
    cub = np.zeros((len(cubs), 8), dtype=np.int32)
    for i, c in enumerate(cubs):
        cub[i, :6] = (c.n0, c.n1, c.m0, c.m1, c.k0, c.k1)
    cub[:, 6] = ld
    return PlanTable(
        proc_off=proc_off.astype(np.int32), cub=cub, rank=rank,
        ws_off=ws_off, cell=np.asarray(cell_rows, dtype=np.int32)
        .reshape(-1, 8), cell_mem=np.asarray(cell_mem, dtype=np.int32),
        ws_elems=int(sizes.sum()))


@dataclasses.dataclass(frozen=True)
class _DeviceTable:
    host: PlanTable
    ints: torch.Tensor     # proc_off, cub, cell, cell_mem
    ws_off: torch.Tensor
    ptrs: tuple[int, ...]  # the four sections' addresses


_TABLES: dict[int, tuple[object, dict]] = {}
_MAX_PLANS = 64


def _device_table(plan, device: torch.device) -> _DeviceTable:
    """The plan's table on the card, built once per (plan, device) and
    kept (the plan object itself is held, so its id stays its own)."""
    held = _TABLES.get(id(plan))
    if held is None or held[0] is not plan:
        if len(_TABLES) >= _MAX_PLANS:
            _TABLES.pop(next(iter(_TABLES)))
        held = _TABLES[id(plan)] = (plan, {})
    key = str(device)
    if key not in held[1]:
        host = plan_table(plan)
        parts = [host.proc_off, host.cub.ravel(), host.cell.ravel(),
                 host.cell_mem]
        ints = torch.from_numpy(np.concatenate(parts).astype(np.int32)).to(
            device)
        offs = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
        ptrs = tuple(ints.data_ptr() + 4 * int(o) for o in offs[:-1])
        held[1][key] = _DeviceTable(
            host, ints, torch.from_numpy(host.ws_off).to(device), ptrs)
    return held[1][key]


def plan_variant(a: torch.Tensor, b: torch.Tensor) -> str:
    """The variant ``matmul_plan_kernel`` takes for these operands."""
    if a.dtype == torch.float32:
        return "wgmma_tf32x3"
    tma = (_row_stride("a", a) % 8 == 0 and _row_stride("b", b) % 8 == 0
           and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    return "wgmma" if tma else "mma_sync"


def _check_library_tiles() -> None:
    """csrc/matmul.cu's walk and cells are the ones the tables and the
    CPU emulations assume."""
    cell = tuple(c_function("matmul", f"matmul_plan_cell_{f}", ())()
                 for f in ("rows", "cols"))
    tile = {v: (c_function("matmul", "matmul_plan_tile_rows", (_I,))(i),
                c_function("matmul", "matmul_plan_tile_cols", (_I,))(i))
            for i, v in enumerate(PLAN_VARIANTS)}
    if cell != PLAN_CELL or tile != PLAN_TILES:
        raise RuntimeError(f"csrc/matmul.cu walks tiles {tile} and cells "
                           f"{cell}, the wrapper's tables {PLAN_TILES} and "
                           f"{PLAN_CELL}")
    _check_library_tiles.done = True


_check_library_tiles.done = False


def matmul_plan_kernel(a: torch.Tensor, b: torch.Tensor, plan
                       ) -> torch.Tensor:
    """Every cuboid of ``plan`` (a ``core.cuboid.MMPlan`` for a (n, k) x
    (k, m) product) in one launch of ``csrc/matmul.cu``: ``matmul_plan``
    in bf16, ``matmul_plan_tf32x3`` in float32 (with, where k is cut, one
    launch of the sums, and in float32 the pre-pass before the walk;
    counted as one).

    a (n, k) and b (k, m): float32 or bfloat16, the same dtype, on one
    CUDA device, each with unit column stride and any row stride.  Returns
    a contiguous (n, m) tensor in ``a.dtype``: per output, the parts of
    the cuboids that cover it, each rounded to ``a.dtype``, added in plan
    order in ``a.dtype``.  On the CPU it returns the plain version.
    """
    if not a.is_cuda and not _work.is_fake(a):
        from repro_torch.kernels.matmul.ref import matmul_plan_ref
        return matmul_plan_ref(a, b, plan)
    n, m, k = _check_operands(a, b)
    if (n, m, k) != (plan.n, plan.m, plan.k):
        raise ValueError(f"a plan for ({plan.n}, {plan.m}, {plan.k}) does not "
                         f"fit operands ({n}, {m}, {k})")
    lda, ldb = _row_stride("a", a), _row_stride("b", b)
    fake = _work.is_fake(a)
    table = None if fake else _device_table(plan, a.device)
    host = plan_table(plan) if fake else table.host
    if host.n_ctas == 0 or n * m == 0:   # k = 0: nothing to multiply
        return torch.zeros((n, m), dtype=a.dtype, device=a.device)
    out = torch.empty((n, m), dtype=a.dtype, device=a.device)
    ws = (torch.empty(host.ws_elems, dtype=a.dtype, device=a.device)
          if host.ws_elems else None)
    if _work.tracing(a) and _work.record_call(
            "matmul_plan", a, lambda fake: _work.matmul_work(
                n, m, k, a.element_size())):
        return out
    if not _check_library_tiles.done:
        _check_library_tiles()
    variant = plan_variant(a, b)
    p_off, p_cub, p_cell, p_mem = table.ptrs
    tables = (p_off, p_cub, table.ws_off.data_ptr(), p_cell, p_mem,
              table.host.n_ctas, len(table.host.cell), n, m, k, lda, ldb)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        ws_ptr = None if ws is None else ws.data_ptr()
        if variant == "wgmma_tf32x3":
            split = _split_workspace(a, n, m, k, lda)
            err = c_function("matmul", "matmul_plan_tf32x3", (
                _P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                _I, _L, _L, _P))(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), ws_ptr,
                split.data_ptr(), split.numel(), *tables, stream)
        else:
            err = c_function("matmul", "matmul_plan", (
                _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                _I, _L, _L, _P))(
                _DTYPES[a.dtype], PLAN_VARIANTS.index(variant), a.data_ptr(),
                b.data_ptr(), out.data_ptr(), ws_ptr, *tables, stream)
    if err:
        raise RuntimeError(f"matmul_plan launch failed: CUDA error {err}")
    matmul_plan_kernel.launches += 1
    matmul_plan_kernel.cuboids += len(table.host.cub)
    matmul_plan_kernel.variants[variant] += 1
    return out


matmul_plan_kernel.launches = 0
matmul_plan_kernel.cuboids = 0
matmul_plan_kernel.variants = collections.Counter()
