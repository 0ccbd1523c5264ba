"""The port's launch tooling (``repro_torch.launch.specs``, ``cost``,
``dryrun``, ``roofline``, ``report``) on the CPU, held to ``repro``'s.

JAX's side comes from ``repro.launch.specs``, ``repro.dist.sharding``,
``NamedSharding.shard_shape`` and ``repro.models.model``; never from
``repro.launch.dryrun`` or ``roofline``, which force 512 host devices at
import.  The port's fake meshes are ``fake``-backend process groups made
and destroyed inside each test.  Every comparison is exact (shapes,
dtypes, bytes, flops and counts are integers or sums of them), except
where a test says otherwise.  About 40 s on one core."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro import configs as jcfg
from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.models.model import active_param_count as j_active
from repro_torch import card
from repro_torch import configs as tcfg
from repro_torch.kernels import work
from repro_torch.launch import cost, dryrun, report, roofline, specs
from repro_torch.train.train_step import TrainConfig

torch.set_num_threads(1)

ARCHS = ("qwen3-0.6b", "gemma2-2b", "codeqwen1.5-7b", "nemotron-4-15b",
         "chameleon-34b", "olmoe-1b-7b", "deepseek-v2-236b", "mamba2-780m",
         "zamba2-7b", "seamless-m4t-medium")
FAMILIES = ("qwen3-0.6b", "deepseek-v2-236b", "mamba2-780m", "zamba2-7b",
            "seamless-m4t-medium")
_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int32": torch.int32}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _sig(tree):
    """{path: (shape, torch dtype)} of a JAX or torch tree."""
    out = {}
    for k, v in _flat(tree).items():
        dt = v.dtype
        dt = dt if isinstance(dt, torch.dtype) else _TORCH_DTYPE[str(dt)]
        out[k] = (tuple(v.shape), dt)
    return out


class _FakeGroup:
    """A ``fake``-backend default group of ``world`` ranks (rank 0)."""

    def __init__(self, world):
        self.world = world

    def __enter__(self):
        dryrun._fake_group(self.world)
        return self

    def __exit__(self, *exc):
        torch.distributed.destroy_process_group()


def _mesh(shape, axes=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def test_shapes_and_rules_match_jax():
    assert {k: dataclasses.astuple(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jcfg.SHAPES.items()}
    for arch in ARCHS:
        for shape in tcfg.SHAPES:
            assert tcfg.cell_applicable(tcfg.get_arch(arch),
                                        tcfg.SHAPES[shape]) == \
                jcfg.cell_applicable(jcfg.get_arch(arch),
                                     jcfg.SHAPES[shape])


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax_full_width(arch):
    """``param_shapes``, ``opt_state_shapes`` and ``input_specs`` of every
    shape cell: JAX's shapes and dtypes, leaf for leaf."""
    cj, ct = jcfg.get_arch(arch), tcfg.get_arch(arch)
    mode = specs.fake_mode()
    pj, pt = jspecs.param_shapes(cj), specs.param_shapes(ct, mode)
    assert _sig(pt) == _sig(pj)
    assert all(work.is_fake(t) for t in _flat(pt).values())
    st = specs.opt_state_shapes(ct, TrainConfig(), pt, mode)
    sj = jspecs.opt_state_shapes(cj, jspecs.TrainConfig(), pj)
    assert _sig(st) == _sig(sj)
    for name in tcfg.SHAPES:
        got = specs.input_specs(ct, tcfg.SHAPES[name], mode)
        want = jspecs.input_specs(cj, jcfg.SHAPES[name])
        assert _sig(got) == _sig(want), name
        assert specs.step_fn_for(ct, tcfg.SHAPES[name])[1] == \
            jspecs.step_fn_for(cj, jcfg.SHAPES[name])[1]


def _jax_arg_bytes(arch, shape_name):
    """Per-device bytes of the step's arguments under ``repro``'s
    shardings on a (16, 16) mesh: the sum of each leaf's shard bytes
    (``repro.launch.dryrun.shardings_for``'s rules, re-stated here)."""
    cj, shape = jcfg.get_arch(arch), jcfg.SHAPES[shape_name]
    devs = np.array(jax.devices() * 256)[:256].reshape(16, 16)
    mesh = Mesh(devs, ("data", "model"))

    def nbytes(leaf, spec):
        shp = NamedSharding(mesh, spec).shard_shape(leaf.shape)
        return int(np.prod(shp)) * jnp.dtype(leaf.dtype).itemsize

    def tree_bytes(tree, spec_tree):
        flat_s = _flat(spec_tree)
        return sum(nbytes(v, flat_s[k]) for k, v in _flat(tree).items())

    params = jspecs.param_shapes(cj)
    pspecs = jsh.param_specs(cj, params, mesh)
    total = tree_bytes(params, pspecs)
    inputs = jspecs.input_specs(cj, shape)
    if shape.kind == "train":
        f32 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape,
                                                          jnp.float32),
                           params)
        total += 2 * tree_bytes(f32, pspecs) + 4      # m, v, step
        total += tree_bytes(inputs["batch"], jsh.batch_specs(
            cj, mesh, inputs["batch"]))
        return total
    b = inputs["tokens"].shape[0]
    cut = b % 16 == 0
    total += nbytes(inputs["tokens"], P("data", None) if cut
                    else P(None, None))
    total += nbytes(inputs["lengths"], P("data") if cut else P(None))
    return total + tree_bytes(inputs["cache"], jsh.cache_specs(
        cj, mesh, inputs["cache"]))


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "deepseek-v2-236b",
                                  "mamba2-780m", "seamless-m4t-medium"))
def test_argument_bytes_on_the_production_mesh_match_jax(arch):
    ct = tcfg.get_arch(arch)
    with _FakeGroup(256):
        mesh = _mesh((16, 16))
        for name in ("train_4k", "decode_32k"):
            pos = dryrun.build_args(ct, tcfg.SHAPES[name],
                                    specs.fake_mode(), TrainConfig(), mesh)
            assert dryrun.local_bytes(pos) == _jax_arg_bytes(arch, name), \
                name


def test_model_flops_match_jax_all_cells():
    for arch in ARCHS:
        cj, ct = jcfg.get_arch(arch), tcfg.get_arch(arch)
        n = j_active(cj, jspecs.param_shapes(cj))
        for name, shape in jcfg.SHAPES.items():
            b, s = shape.global_batch, shape.seq_len
            want = {"train": 6.0 * n * b * s, "prefill": 2.0 * n * b * s,
                    "decode": 2.0 * n * b}[shape.kind]
            assert roofline.model_flops(ct, tcfg.SHAPES[name]) == want


def test_counters_on_a_fake_mesh():
    """A 4-rank fake mesh: Shard(0) -> Replicate of an f32 (64, 128) is one
    all-gather of 32,768 bytes a rank, Partial -> Replicate one
    all-reduce, and a Shard(0) matmul 2 n m k / 4 flops a rank (the local
    product, never the global one)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    with _FakeGroup(4):
        mesh = _mesh((4,), ("data",))
        with specs.fake_mode():
            x = DTensor.from_local(torch.empty(16, 128), mesh, (Shard(0),),
                                   run_check=False)
            w = DTensor.from_local(torch.empty(128, 32), mesh,
                                   (Replicate(),), run_check=False)
            with cost.StepCounters(mesh) as c:
                x.redistribute(mesh, (Replicate(),))
            assert c.collectives.stats == {"all-gather": {
                "count": 1, "bytes": 64 * 128 * 4,
                "axes": {"data": {"count": 1, "bytes": 32768}}}}
            assert c.flops.total() == 0
            with cost.StepCounters(mesh) as c:
                DTensor.from_local(torch.empty(16, 128), mesh, (Partial(),),
                                   run_check=False).redistribute(
                    mesh, (Replicate(),))
            assert set(c.collectives.stats) == {"all-reduce"}
            assert c.collectives.stats["all-reduce"]["count"] == 1
            assert c.collectives.stats["all-reduce"]["bytes"] == 16 * 128 * 4
            with cost.StepCounters(mesh) as c:
                y = x @ w
            assert y.to_local().shape == (16, 32)
            assert c.flops.total() == 2 * 64 * 32 * 128 / 4
            assert c.bytes.total() == 4 * (16 * 128 + 128 * 32 + 16 * 32)
            assert not c.collectives.stats


def _reduced(arch):
    return tcfg.get_arch(arch).reduced()


@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_dryrun_of_each_family_on_a_2x2_fake_mesh(arch):
    cfg = _reduced(arch)
    with _FakeGroup(4):
        mesh = _mesh((2, 2))
        for kind in ("train", "prefill", "decode"):
            rec = dryrun.trace_cell(cfg, tcfg.ShapeCell("t", 32, 4, kind),
                                    mesh)
            m = rec["memory"]
            assert rec["cost"]["flops_per_device"] > 0, kind
            assert m["peak_bytes_per_device"] >= m["argument_bytes"] > 0
            json.dumps(rec)


def test_dryrun_counts_the_key_cut_on_a_fake_5_rank_mesh():
    """Reduced gemma2-2b's train step traced on a (1, 5) ``fake`` mesh
    (the dry-run's path): its 2 layers' attention takes the key-block
    entries (forward twice with remat, backward once; no whole-sequence
    flash call), each call recorded by the block formula of rank 0's 8
    keys, and the merge's all-reduces counted on the model axis: three a
    forward (max, and the sums of the weights and of the f32 O) and dQ's
    one a backward."""
    cfg = _reduced("gemma2-2b")
    b, s = 2, 40
    with _FakeGroup(5):
        rec = dryrun.trace_cell(cfg, tcfg.ShapeCell("t", s, b, "train"),
                                _mesh((1, 5)))
    n = cfg.n_layers
    assert rec["cost"]["kernel_calls"] == {"flash_fwd_block": 2 * n,
                                           "flash_bwd_block": n}
    from repro_torch.models.transformer import _layer_windows
    windows = _layer_windows(cfg, n)
    assert rec["cost"]["kernel_flops"]["flash_fwd_block"] == sum(
        2 * work.flash_fwd_work(b, s, 8, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, 4, window=w, k_off=0)[0]
        for w in windows)
    model = rec["collectives"]["all-reduce"]["axes"]["model"]
    o_bytes = b * s * cfg.n_heads * cfg.head_dim * 4
    assert model["count"] >= 3 * 2 * n + n
    assert model["bytes"] >= (2 * n + n) * o_bytes
    assert "world" not in rec["collectives"]["all-reduce"]["axes"]


def test_key_cut_reduce_scatters_kv_on_a_fake_8_rank_mesh(monkeypatch):
    """On a (1, 8) ``fake`` mesh reduced gemma2-2b's K and V projections
    (64 -> 2 heads x 16, row-parallel) leave partial sums: under the key
    cut they reduce-scatter straight to their blocks of 5 keys, where
    gathering the heads first (``layers.key_cut`` forced off) all-reduces
    them whole.  Each forward of a layer (2 with remat) has two such
    collectives: the all-reduces' bytes fall by those whole K/V and the
    reduce-scatters' rise by an eighth of them; K and V reach the key cut
    laid out over the keys."""
    from repro_torch.models import layers

    cfg = _reduced("gemma2-2b")
    b, s, pm = 2, 40, 8
    inner, laid = layers._sharded_attention, set()

    def spy(q, k, v, **kw):
        laid.add(tuple(tuple(p.dim if p.is_shard() else None
                             for p in t.placements) for t in (k, v)))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(layers, "_sharded_attention", spy)
    recs = {}
    for cut in (True, False):
        if not cut:
            monkeypatch.setattr(layers, "key_cut", lambda *a: False)
        with _FakeGroup(pm):
            recs[cut] = dryrun.trace_cell(
                cfg, tcfg.ShapeCell("t", s, b, "train"), _mesh((1, pm)))
        if cut:
            assert laid == {((None, 1), (None, 1))}
    whole = b * s * cfg.n_kv_heads * cfg.head_dim * 4     # f32 K or V
    calls = 2 * 2 * cfg.n_layers
    axes = {cut: {kind: recs[cut]["collectives"][kind]["axes"]["model"]
                  for kind in ("all-reduce", "reduce-scatter")}
            for cut in recs}
    ar = [axes[c]["all-reduce"] for c in (False, True)]
    rs = [axes[c]["reduce-scatter"] for c in (False, True)]
    assert ar[0]["count"] - ar[1]["count"] == calls
    assert ar[0]["bytes"] - ar[1]["bytes"] == calls * whole
    assert rs[1]["count"] - rs[0]["count"] == calls
    assert rs[1]["bytes"] - rs[0]["bytes"] == calls * whole // pm
    assert recs[True]["cost"]["kernel_calls"] == \
        recs[False]["cost"]["kernel_calls"]


def test_reduced_qwen3_train_flops_equal_the_worked_count():
    """No mesh: each projection's 2 tokens d_in d_out, four times in a
    remat block (forward, recompute, and the two products of its
    gradient), but three for the down projection (the recompute stops
    early: the block's last product feeds no saved tensor) and for the
    tied head outside the blocks; each layer's flash forward twice and
    its backward once, by ``cost``'s formulas."""
    cfg = _reduced("qwen3-0.6b")
    b, s = 2, 32
    rec = dryrun.trace_cell(cfg, tcfg.ShapeCell("t", s, b, "train"))
    t, d, dh, f = b * s, cfg.d_model, cfg.head_dim, cfg.d_ff
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    proj = 2 * t * (d * hq * dh + 2 * d * hkv * dh + hq * dh * d + 2 * d * f)
    down = 2 * t * f * d
    head = 2 * t * d * cfg.padded_vocab
    fwd, _ = work.flash_fwd_work(b, s, s, hq, hkv, dh, 4)
    bwd, _ = work.flash_bwd_work(b, s, s, hq, hkv, dh, 4)
    want = cfg.n_layers * (4 * proj + 3 * down + 2 * fwd + bwd) + 3 * head
    assert cfg.tie_embeddings
    assert rec["cost"]["flops_per_device"] == want
    assert rec["cost"]["kernel_calls"] == {"flash_fwd": 2 * cfg.n_layers,
                                           "flash_bwd": cfg.n_layers}


def test_kernel_fake_paths_record_their_formula():
    """Every kernel entry on fake tensors: fake outputs, its formula's
    flops and bytes in the open counter, no launch counted and no
    library loaded (no data pointer is read: a fake tensor has none)."""
    from repro_torch.core import plan_mm_1piece
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.build import LIBS
    from repro_torch.kernels.lcs.lcs import lcs_table_kernel
    from repro_torch.kernels.matmul.matmul import (matmul_kernel,
                                                   matmul_plan_kernel)

    bf = torch.bfloat16
    launches = {f: f.launches for f in (
        K.paged_flash_decode, K.paged_flash_prefill, K.paged_flash_verify,
        K.paged_latent_decode, K.paged_latent_prefill, K.paged_latent_verify,
        K.flash_attention, K.flash_attention_bwd, matmul_kernel,
        matmul_plan_kernel, lcs_table_kernel)}
    b, hq, hkv, d, page, width, pool = 2, 4, 2, 64, 16, 4, 9
    kv, rope, h = 32, 16, 4
    with specs.fake_mode():
        e = lambda *shp, dt=bf: torch.empty(shp, dtype=dt)  # noqa: E731
        i32 = torch.int32
        calls = [
            ("paged_decode", lambda: K.paged_flash_decode(
                e(b, 1, hq, d), e(pool, page, hkv, d), e(pool, page, hkv, d),
                e(b, width, dt=i32), e(b, dt=i32), scale=0.1),
             work.paged_work(b * hq * d, b * width, b, b * width * page,
                             b * width * page, hq, hkv, d, 2)),
            ("paged_prefill", lambda: K.paged_flash_prefill(
                e(1, 16, hq, d), e(pool, page, hkv, d),
                e(pool, page, hkv, d), e(width, dt=i32), 32, scale=0.1),
             work.paged_work(16 * hq * d, width, 0, 48,
                             16 * 32 + 16 * 17 // 2, hq, hkv, d, 2)),
            ("paged_verify", lambda: K.paged_flash_verify(
                e(b, 3, hq, d), e(pool, page, hkv, d), e(pool, page, hkv, d),
                e(b, width, dt=i32), e(b, dt=i32), scale=0.1),
             work.paged_work(b * 3 * hq * d, b * width, b, b * width * page,
                             b * 3 * width * page, hq, hkv, d, 2)),
            ("paged_latent_decode", lambda: K.paged_latent_decode(
                e(b, 1, h, kv), e(b, 1, h, rope), e(pool, page, kv),
                e(pool, page, rope), e(b, width, dt=i32), e(b, dt=i32),
                scale=0.1),
             work.latent_work(b * h * kv, b * h * rope, b * width, b,
                              b * width * page, b * width * page, h, kv,
                              rope, 2)),
            ("paged_latent_prefill", lambda: K.paged_latent_prefill(
                e(1, 16, h, kv), e(1, 16, h, rope), e(pool, page, kv),
                e(pool, page, rope), e(width, dt=i32), 16, scale=0.1),
             work.latent_work(16 * h * kv, 16 * h * rope, width, 0, 32,
                              16 * 16 + 16 * 17 // 2, h, kv, rope, 2)),
            ("paged_latent_verify", lambda: K.paged_latent_verify(
                e(b, 3, h, kv), e(b, 3, h, rope), e(pool, page, kv),
                e(pool, page, rope), e(b, width, dt=i32), e(b, dt=i32),
                scale=0.1),
             work.latent_work(b * 3 * h * kv, b * 3 * h * rope, b * width, b,
                              b * width * page, b * 3 * width * page, h, kv,
                              rope, 2)),
            ("flash_fwd", lambda: K.flash_attention(
                e(b, 64, hq, d), e(b, 64, hkv, d), e(b, 64, hkv, d)),
             work.flash_fwd_work(b, 64, 64, hq, hkv, d, 2)),
            ("flash_bwd", lambda: K.flash_attention_bwd(
                e(b, 64, hq, d), e(b, 64, hkv, d), e(b, 64, hkv, d),
                e(b, 64, hq, d), e(b, hq, 64, dt=torch.float32),
                e(b, 64, hq, d), window=16),
             work.flash_bwd_work(b, 64, 64, hq, hkv, d, 2, window=16)),
            ("matmul", lambda: matmul_kernel(e(48, 40), e(40, 24)),
             work.matmul_work(48, 24, 40, 2)),
            ("matmul_plan", lambda: matmul_plan_kernel(
                e(64, 32), e(32, 48), plan_mm_1piece(64, 48, 32, 5)),
             work.matmul_work(64, 48, 32, 2)),
            ("lcs_table", lambda: lcs_table_kernel(
                *(e(n, dt=i32) for n in (40, 24, 24, 40, 1)), 8, 8),
             work.lcs_work(40, 24)),
        ]
        for name, call, (flops, nbytes) in calls:
            with cost.StepCounters() as c:
                out = call()
            outs = out if isinstance(out, tuple) else (out,)
            assert all(work.is_fake(o) for o in outs), name
            assert c.kernel_calls == {name: 1}, name
            assert c.flops.kernel_flops[name] == flops, name
            assert c.bytes.kernel_bytes[name] == nbytes, name
    assert {f: f.launches for f in launches} == launches
    assert not LIBS._libs


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.float32, 64),
                                     (torch.float32, 16),
                                     (torch.bfloat16, 128)])
@pytest.mark.parametrize("entry", ["whole", "block"])
def test_fake_flash_calls_hold_the_float32_workspace(entry, dtype, d):
    """The flash pair on fake tensors under the dry-run's MemTracker: the
    peak is the inputs, the outputs (O and lse; dq, dk, dv and the Delta
    scratch) and, for the float32 family (f32 at D 64 and 128), the
    workspace ``tf32x3_ws_floats`` sizes (the same bytes a real call
    allocates: 3.0 MB for the backward at this shape, D 128), through the
    whole-sequence and the key-block entries alike; bf16 and f32 at D 16
    take none.  No library is loaded."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.build import LIBS

    b, sq, sk, hq, hkv = 1, 200, 136, 4, 2
    nbytes = lambda *ts: sum(t.numel() * t.element_size()  # noqa: E731
                             for t in ts)
    for lib in ("flash_fwd", "flash_bwd"):
        with specs.fake_mode():
            e = lambda *shp, dt=dtype: torch.empty(shp, dtype=dt)  # noqa
            q, o, d_o = e(b, sq, hq, d), e(b, sq, hq, d), e(b, sq, hq, d)
            k, v = e(b, sk, hkv, d), e(b, sk, hkv, d)
            lse = e(b, hq, sq, dt=torch.float32)
            ins = (q, k, v) if lib == "flash_fwd" else (q, k, v, o, lse, d_o)
            mt = MemTracker()
            mt.track_external(*ins)
            with mt:
                if lib == "flash_fwd" and entry == "whole":
                    outs = K._flash_fwd(q, k, v, causal=False, window=None,
                                        logit_cap=None)
                elif lib == "flash_fwd":
                    outs = K.flash_attention_block(q, k, v, k_off=64,
                                                   causal=False)
                elif entry == "whole":
                    outs = K.flash_attention_bwd(q, k, v, o, lse, d_o,
                                                 causal=False)
                else:
                    outs = K.flash_attention_block_bwd(q, k, v, o, lse, d_o,
                                                       k_off=64, causal=False)
            peak = sum(x["Total"]
                       for x in mt.get_tracker_snapshot("peak").values())
        delta = 0 if lib == "flash_fwd" else nbytes(lse)
        ws = (4 * K.tf32x3_ws_floats(lib, b, sq, sk, hq, hkv, d)
              if K._tf32x3(dtype, d) else 0)
        assert (d in K.TF32X3_WIDTHS and dtype == torch.float32) == (ws > 0)
        assert peak == nbytes(*ins) + nbytes(*outs) + delta + ws, (lib,
                                                                   peak)
    assert not LIBS._libs


def test_kernel_formulas_keep_the_tables_bounds():
    """``cost``'s formulas give the bytes and flops of the kernels line
    as ``chip_smoke.py`` last printed them on the card (the table's
    shapes; the paged rows' keys as that run drew them), and rows 5 and 1
    their bounds, 0.1390 and 0.0060 ms on the data-sheet H100 (to the
    table's four places)."""
    peak, hbm = card.PEAK_FLOPS[torch.bfloat16], card.HBM_BYTES_PER_S

    def bound_ms(flops, nbytes, dt=torch.bfloat16):
        return max(flops / card.PEAK_FLOPS[dt], nbytes / hbm) * 1e3

    rows = {
        "flash_attention": (work.flash_fwd_work(2, 4096, 4096, 16, 8, 128, 2),
                            (137472507904, 101187584)),
        "flash_attention_bwd": (work.flash_bwd_work(2, 4096, 4096, 16, 8,
                                                    128, 2),
                                (343681269760, 201850880)),
        "flash_attention_cross": (work.flash_fwd_work(
            2, 256, 1024, 16, 16, 64, 2, causal=False),
            (2147483648, 10518528)),
        "flash_attention_d112": (work.flash_fwd_work(1, 2048, 2048, 32, 32,
                                                     112, 2),
                                 (30079451136, 58982400)),
        "paged_decode": (work.paged_work(8 * 16 * 128, 8 * 32, 8, 4930,
                                         4930, 16, 8, 128, 2),
                         (40386560, 20259872)),
        "matmul_plan": (work.matmul_work(8192, 8192, 8192, 2),
                        (1099511627776, 402653184)),
        "matmul": (work.matmul_work(2048, 2048, 2048, 4),
                   (17179869184, 50331648)),
        "lcs_tile": (work.lcs_work(65536, 65536), (17179869184, 1048576)),
    }
    for name, (got, want) in rows.items():
        assert got == want, name
    assert round(bound_ms(*rows["flash_attention"][0]), 4) == 0.1390
    assert round(bound_ms(*rows["paged_decode"][0]), 4) == 0.0060
    assert peak == 989e12 and hbm == 3.35e12


def test_axis_links_follow_the_rank_order():
    """At 8 cards a node: a (16, 16) mesh's both axes cross nodes, a
    (2, 4) mesh's stay within one, a (4, 4) mesh's model axis stays and
    its data axis crosses."""
    nd, nv = card.NDR_BYTES_PER_S, card.NVLINK_BYTES_PER_S
    assert roofline.axis_links({"data": 16, "model": 16}) == {
        "data": nd, "model": nd}
    assert roofline.axis_links({"pod": 2, "data": 16, "model": 16}) == {
        "pod": nd, "data": nd, "model": nd}
    assert roofline.axis_links({"data": 2, "model": 4}) == {
        "data": nv, "model": nv}
    assert roofline.axis_links({"data": 4, "model": 4}) == {
        "data": nd, "model": nv}


def test_report_renders_the_tables(tmp_path):
    """Records of a reduced trace (and a skipped and a failed cell)
    written to tmp_path render into both tables."""
    dr_dir, rf_dir = tmp_path / "dryrun", tmp_path / "roofline"
    dr_dir.mkdir()
    rf_dir.mkdir()
    cfg = _reduced("qwen3-0.6b")
    traced = dryrun.trace_cell(cfg, tcfg.ShapeCell("t", 32, 4, "train"))
    ok = {"arch": "qwen3-0.6b", "shape": "train_4k", "mesh": "single",
          "status": "ok", "devices": 256, **traced}
    skipped = {"arch": "qwen3-0.6b", "shape": "long_500k", "mesh": "single",
               "status": "skipped", "why": "full-attention arch"}
    failed = {"arch": "gemma2-2b", "shape": "train_4k", "mesh": "single",
              "status": "error", "fn": "train_step", "error": "Boom: x"}
    for r in (ok, skipped, failed):
        (dr_dir / f"single_{r['arch']}_{r['shape']}.json").write_text(
            json.dumps(r))
    full = tcfg.get_arch("qwen3-0.6b")
    roof = {"arch": "qwen3-0.6b", "shape": "train_4k",
            **roofline.roofline_of(full, tcfg.SHAPES["train_4k"], ok)}
    (rf_dir / "qwen3-0.6b_train_4k.json").write_text(json.dumps(roof))
    table = report.dryrun_table("single", str(dr_dir))
    lines = table.splitlines()
    assert len(lines) == 2 + 3
    assert "| qwen3-0.6b | train_4k | train_step |" in table
    assert "skipped: full-attention arch" in table
    assert "ERROR" in table and "Boom" in table
    rt = report.roofline_table(str(rf_dir)).splitlines()
    assert len(rt) == 3 and rt[2].startswith("| qwen3-0.6b | train_4k |")
    assert roof["dominant"] in rt[2]
    assert report.dryrun_table("multi", str(dr_dir)).count("\n") == 1
