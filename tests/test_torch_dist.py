"""The port's distribution planners held to ``repro``'s, with no process
group: ``repro_torch.dist.sharding``'s param, batch, cache and paged-pool
specs for all ten archs at full width on six meshes, ``spec_for``,
``paco_spec``, the ``_weight_spec`` rules, ``stage_ranges``,
``make_mesh_for``'s shapes and the ``ft`` planners, each equal to JAX's
entry for entry.  The port's specs are computed from plain axis -> size
dicts (its parameter shapes from ``init_params`` under ``FakeTensorMode``,
which allocates nothing), JAX's from a fake mesh of repeated CPU devices.
One case builds a 256-rank (16, 16) ``DeviceMesh`` on the ``fake``
backend in this process and holds every full-width qwen3-0.6b and
deepseek-v2 leaf's local shard shape to ``NamedSharding.shard_shape``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro import configs as jcfg
from repro import models as jmodels
from repro.core.matmul import paco_spec as j_paco_spec
from repro.dist import act_sharding as jact
from repro.dist import pipeline as jpipe
from repro.dist import sharding as jsh
from repro.ft import elastic as jel
from repro.ft import straggler as jstr
from repro_torch import configs as tcfg
from repro_torch import models as tmodels
from repro_torch.core.matmul import paco_spec as t_paco_spec
from repro_torch.dist import act_sharding as tact
from repro_torch.dist import pipeline as tpipe
from repro_torch.dist import sharding as tsh
from repro_torch.ft import elastic as tel
from repro_torch.ft import straggler as tstr

torch.set_num_threads(1)

ARCHS = ("qwen3-0.6b", "gemma2-2b", "codeqwen1.5-7b", "nemotron-4-15b",
         "chameleon-34b", "olmoe-1b-7b", "deepseek-v2-236b", "mamba2-780m",
         "zamba2-7b", "seamless-m4t-medium")
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((7, 1), ("data", "model")), ((1, 7), ("data", "model")))
MESH_IDS = ["x".join(map(str, s)) + "-" + a[0] for s, a in MESHES]


def _jax_mesh(shape, axes):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices() * n)[:n].reshape(shape), axes)


def _sizes(shape, axes):
    return dict(zip(axes, shape))


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts (JAX specs are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    """({path: shape} of JAX's params, of the port's), at full width."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cj, ct = jcfg.get_arch(arch), tcfg.get_arch(arch)
    jp = jax.eval_shape(lambda: jmodels.init_params(cj,
                                                    jax.random.PRNGKey(0)))
    with FakeTensorMode():
        tp = tmodels.init_params(ct, device="cpu")
    return ({k: tuple(v.shape) for k, v in _flat(jp).items()},
            {k: tuple(v.shape) for k, v in _flat(tp).items()})


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _specs_equal(j_specs, t_specs):
    j, t = _flat(j_specs), _flat(t_specs)
    assert set(j) == set(t)
    for k in j:
        assert tuple(j[k]) == t[k], (k, j[k], t[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax_full_width(arch):
    j_shapes, t_shapes = _param_shapes(arch)
    assert j_shapes == t_shapes
    cj, ct = jcfg.get_arch(arch), tcfg.get_arch(arch)
    jtree = {k: jax.ShapeDtypeStruct(s, jnp.float32)
             for k, s in j_shapes.items()}
    ttree = {k: _Shape(s) for k, s in t_shapes.items()}
    for shape, axes in MESHES:
        js = jsh.param_specs(cj, _nest(jtree), _jax_mesh(shape, axes))
        ts = tsh.param_specs(ct, _nest(ttree), _sizes(shape, axes))
        _specs_equal(js, ts)


def _nest(flat):
    """{path: leaf} -> nested dicts."""
    out: dict = {}
    for path, leaf in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_and_pool_specs_match_jax(arch):
    cj, ct = jcfg.get_arch(arch), tcfg.get_arch(arch)
    batch = {"tokens": (256, 4096), "labels": (256, 4096)}
    if cj.family == "encdec":
        batch["src_emb"] = (256, 1024, cj.d_model)
    j_cache = jmodels.cache_spec(cj, 128, 32768)
    t_cache = tmodels.cache_spec(ct, 128, 32768)
    assert ({k: tuple(v.shape) for k, v in j_cache.items()}
            == {k: tuple(v.shape) for k, v in t_cache.items()})
    pools = None
    if cj.family == "decoder":
        leaves = jmodels.paged_cache_leaf_specs(cj, 64)
        t_leaves = tmodels.paged_cache_leaf_specs(ct, 64)
        assert ({k: tuple(v.shape) for k, v in leaves.items()}
                == {k: tuple(v.shape) for k, v in t_leaves.items()})
        pools = {k: jax.ShapeDtypeStruct(
            (v.shape[0], 1025, *v.shape[1:]), jnp.float32)
            for k, v in leaves.items()}
    for shape, axes in MESHES:
        jm, tm = _jax_mesh(shape, axes), _sizes(shape, axes)
        js = jsh.batch_specs(cj, jm, {k: jax.ShapeDtypeStruct(s, jnp.int32)
                                      for k, s in batch.items()})
        _specs_equal(js, tsh.batch_specs(ct, tm, {k: _Shape(s) for k, s
                                                  in batch.items()}))
        _specs_equal(jsh.cache_specs(cj, jm, j_cache),
                     tsh.cache_specs(ct, tm, t_cache))
        if pools is not None:
            _specs_equal(jsh.paged_pool_specs(cj, jm, pools),
                         tsh.paged_pool_specs(ct, tm, pools))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_spec_for_matches_jax(mesh):
    shape, axes = mesh
    jm, tm = _jax_mesh(shape, axes), _sizes(shape, axes)
    cases = [((256, 4096, 1024), ("dp", None, None)),
             ((16, 4096, 1024), ("dp", None, None)),
             ((8, 128, 16, 128), ("dp", None, "model", None)),
             ((8, 128, 14, 64), ("dp", None, "model", None)),
             ((14, 7, 3, 64), ("dp", "model", None, None)),
             ((32, 64), ("data", "model")), ((64, 7), ("model", "dp")),
             ((2, 32), ("pod", "dp")), ((1, 1, 1), (None, "dp", "model"))]
    for s, names in cases:
        assert tuple(jact.spec_for(jm, s, names)) == tact.spec_for(
            tm, s, names), (s, names)


def test_paco_spec_and_weight_spec_rules():
    """tests/test_dist.py's paco_spec cases and tests/test_launch.py's
    ``_weight_spec`` rules, on both packages."""
    for n, m, k in ((64, 64, 4096), (4096, 64, 64), (64, 4096, 64),
                    (100, 100, 100), (7, 3, 5)):
        j = j_paco_spec(n, m, k, 8, "model")
        t = t_paco_spec(n, m, k, 8, "model")
        assert tuple(tuple(x) for x in j[:3]) == t[:3] and j[3] == t[3]
    sa, sb, sc, psum = t_paco_spec(64, 64, 4096, 8, "model")
    assert psum and sa == (None, "model") and sb == ("model", None)
    assert sc == (None, None)
    jm, tm = _jax_mesh((16, 16), ("data", "model")), {"data": 16,
                                                       "model": 16}
    assert tsh._weight_spec(1024, 4096, tm) == ("data", "model")
    assert tsh._weight_spec(4096, 1024, tm) == ("model", "data")
    assert tsh._weight_spec(1024, 4090, tm)[0] == "model"
    for d_in, d_out in ((1024, 4096), (4096, 1024), (1024, 4090),
                        (4090, 4090), (63, 4096), (7, 9)):
        assert tuple(jsh._weight_spec(d_in, d_out, jm)) == \
            tsh._weight_spec(d_in, d_out, tm)


def test_pool_and_verify_shardings_match_jax():
    """``pool_shardings`` / ``verify_shardings``: the placements of JAX's
    NamedShardings' specs, for GQA heads that do and do not divide."""
    for arch in ("qwen3-0.6b", "gemma2-2b", "deepseek-v2-236b"):
        cj, ct = jcfg.get_arch(arch), tcfg.get_arch(arch)
        leaves = jmodels.paged_cache_leaf_specs(cj, 64)
        pools = {k: jax.ShapeDtypeStruct((v.shape[0], 65, *v.shape[1:]),
                                         jnp.float32)
                 for k, v in leaves.items()}
        for shape, axes in MESHES[2:]:
            jm, tm = _jax_mesh(shape, axes), _sizes(shape, axes)
            want = {k: tact.placements(tm, tuple(v.spec)) for k, v in
                    jsh.pool_shardings(cj, jm, pools).items()}
            assert tsh.pool_shardings(ct, tm, pools) == want
            j_ver = jsh.verify_shardings(cj, jm, pools)
            t_ver = tsh.verify_shardings(ct, tm, pools)
            for j, t in zip(j_ver[:3], t_ver[:3]):
                assert tact.placements(tm, tuple(j.spec)) == t
            assert t_ver[3] == want


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    tm = {"pod": 2, "data": 4, "model": 2}
    assert tact.placements(tm, (("data", "model"), None)) == (
        Replicate(), Shard(0), Shard(0))
    assert tact.placements(tm, (None, "model", ("pod", "data"))) == (
        Shard(2), Shard(2), Shard(1))
    assert tact.placements(tm, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        tact.placements(tm, (("model", "data"),))
    # a cut over an axis of size 1 is no cut
    assert tact.placements({"data": 1, "model": 2}, ("data", "model")) == (
        Replicate(), Shard(1))


def test_stage_ranges_match_jax():
    for n_layers in range(0, 41):
        for n_stages in range(1, 18):
            got = tpipe.stage_ranges(n_layers, n_stages)
            assert got == jpipe.stage_ranges(n_layers, n_stages)
            sizes = [hi - lo for lo, hi in got]
            assert sum(sizes) == n_layers and max(sizes) - min(sizes) <= 1


def test_make_mesh_for_shapes_match_jax():
    for p in range(1, 17):
        # p devices whatever this process's device count (a test that
        # imported repro.launch.dryrun may have set it to 512)
        jm = jel.make_mesh_for(jax.devices()[:1] * p)
        assert tel.mesh_shape_for(p) == (jm.shape["data"],
                                         jm.shape["model"]), p
    assert tel.mesh_shape_for(12, model_axis=4) == (3, 4)


def test_ft_planners_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n_hosts = int(rng.integers(1, 9))
        t = rng.uniform(0.2, 3.0, n_hosts)
        gb, q = int(rng.integers(n_hosts, 512)), int(rng.choice([1, 2, 4]))
        assert (tstr.rebalance_batch(t, gb, quantum=q)
                == jstr.rebalance_batch(t, gb, quantum=q))
        assert tstr.straggler_speedup(t) == jstr.straggler_speedup(t)
        n, m, k = (int(v) for v in rng.integers(8, 300, 3))
        jp, tp = jstr.hetero_tp_plan(n, m, k, t), tstr.hetero_tp_plan(n, m,
                                                                     k, t)
        assert jp.per_proc_volume() == tp.per_proc_volume()
        tracker_j = jstr.ThroughputTracker(n_hosts)
        tracker_t = tstr.ThroughputTracker(n_hosts)
        for _ in range(3):
            st = rng.uniform(0.5, 2.0, n_hosts)
            np.testing.assert_array_equal(tracker_j.update(st),
                                          tracker_t.update(st))
    for args in ((4096, 4096, 4096, 8, 7), (8192, 1024, 512, 16, 13),
                 (1000, 999, 998, 5, 3), (64, 64, 64, 2, 1)):
        assert tel.replan_report(*args) == jel.replan_report(*args)


def test_fake_backend_shard_shapes_match_jax():
    """A 256-rank (16, 16) DeviceMesh on the fake backend in this
    process: every full-width qwen3-0.6b and deepseek-v2 leaf laid out by
    ``distribute`` (meta tensors, no data) has JAX's shard shape."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        jm = _jax_mesh((16, 16), ("data", "model"))
        for arch in ("qwen3-0.6b", "deepseek-v2-236b"):
            cj, ct = jcfg.get_arch(arch), tcfg.get_arch(arch)
            _, t_shapes = _param_shapes(arch)
            tree = _nest({k: torch.empty(s, device="meta")
                          for k, s in t_shapes.items()})
            specs = tsh.param_specs(ct, tree, mesh)
            assert specs == tsh.param_specs(ct, tree, {"data": 16,
                                                       "model": 16})
            laid = _flat(tsh.distribute(mesh, tree, specs))
            for k, spec in _flat(specs).items():
                want = NamedSharding(jm, P(*spec)).shard_shape(
                    t_shapes[k])
                assert tuple(laid[k].to_local().shape) == tuple(want), \
                    (arch, k, spec)
                assert tuple(laid[k].shape) == t_shapes[k]
    finally:
        dist.destroy_process_group()


def test_constraints_are_identity_without_a_mesh():
    x = torch.randn(2, 3, 4, 5)
    assert not tact.active() and tact.model_size() == 1
    assert tact.heads(x) is x and tact.residual(x[..., 0]) is not None
    with tact.use_mesh_rules({"data": 2, "model": 2}):
        assert tact.active() and tact.model_size() == 2
        assert tact.dp_size() == 2
        assert tact.constrain(x, "dp", None, "model", None) is x
    assert not tact.active()
    assert tact.local_call(lambda a, b: a + b, ((None,) * 4, None), 0,
                           x, 1).equal(x + 1)
